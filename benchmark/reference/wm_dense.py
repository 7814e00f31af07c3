"""Plain Walton-Manolopoulos (Filinov-filtered) propagation of a molecule
on an sGDML force field, dense: the trajectories, monodromy and taylor
window of `hk_dense`, and per step the WM tensors of the projected
A (2r, 2r) and M (r, r) matrices (Walton and Manolopoulos' eqns. 50-84:
A, BQ, Gt(t), Gti, CQQ, CqQ, PIQ, M, Rqq, RQQ, RqQ, Pq, PQ, gamma), each
inverse and determinant by the library's pivoted LU (A balanced first,
M scaled), and the observables of eqns. 85, 89-100. The three square
roots (of the HK C^2, det A and det M) are followed across the negative
real axis."""

import math

import numpy as np
import torch

from reference.common import HBAR, ZERO
from reference.hk_dense import (Batch, SignedRoot, checked, hk_prefactor2,
                                molecule, pinv_eigh, rank, run_plain,
                                trajectories)

__all__ = ["repetition", "rank"]


def _logdet(G, scale):
    """The log pseudo-determinant of G / scale over its positive
    eigenvalues."""
    e = np.linalg.eigvalsh(G)
    return float(np.sum(np.log(e[e > ZERO] / scale)))


def _bilinear(x, R, y):
    return torch.einsum("ni,nij,nj->n", x, R, y)


def propagate(mol, task, normals, dtype=torch.float64):
    """One repetition of WM dynamics with cell widths alpha = beta =
    `cell_width`: returns {"cauto", "kic", "ntraj"}."""
    b = Batch(mol, normals, dtype)
    t, cd, G, U = b.t, b.cdt, mol.G0, b.U
    c = lambda x: x.to(cd)
    d, r = U.shape
    alpha = beta = float(task.get("cell_width", 10000.0))
    Gi = Gt = G
    iG0 = pinv_eigh(G)[0]
    ld0, ldi, ldt = (_logdet(x, math.pi) for x in (G, Gi, Gt))
    ldi0 = _logdet(G + Gi, 2.0 * math.pi)
    auto_pref = math.exp(0.25 * ldt + 0.25 * ldi - 0.5 * ldi0)
    m_scale = 2.0 * math.pi * math.exp(ld0 / r)
    s_ab = 2.0 * math.sqrt(alpha * beta)
    A_const = np.zeros((2 * r, 2 * r), dtype=complex)
    A_const[:r, :r] = 2.0 * alpha * (U.T @ G @ U) + U.T @ Gi @ U
    A_const[r:, r:] = 2.0 * beta * (U.T @ iG0 @ U)
    A_const[r:, :r] = -2j / HBAR * np.eye(r)
    # det-preserving balance of A / s: D = blockdiag(W^-1/2, W^1/2), W =
    # U^T G0 U, brings its blocks to O(1) for the elimination
    ew, Vw = np.linalg.eigh(U.T @ G @ U)
    D = np.zeros((2 * r, 2 * r))
    D[:r, :r] = (Vw / np.sqrt(ew)) @ Vw.T
    D[r:, r:] = (Vw * np.sqrt(ew)) @ Vw.T
    D = t(D, cd)
    iGi0 = b.iGi0
    A_const, BqU = t(A_const, cd), t(np.concatenate(
        [Gi @ U, (-1j / HBAR) * U], axis=1), cd)
    Uc, Ut = t(U, cd), t(U)
    G0U, W = t(G @ U, cd), t(U.T @ G @ U, cd)
    Gt_c, G0_c, iGi0_c = t(Gt, cd), t(G, cd), t(iGi0, cd)
    G0iGi0 = t(G @ iGi0)
    Cqq = t(G - G @ iGi0 @ G, cd)
    q0, p0 = b.q0, b.p0

    # the initial point's constants (eqns. 72, 74 with b0 = 0)
    dp0 = p0[None] - b.pi
    eps = -(0.5 / HBAR ** 2) * torch.einsum("na,ab,nb->n", dp0, t(iGi0),
                                            dp0)
    PIq = c(p0[None] - dp0 @ G0iGi0.T)
    n1 = c(-HBAR ** 2 * t(mol.nac) * b.inv_m)[None].expand(b.n, d)
    dq = c(q0[None] - b.qi)
    dp0c = c(dp0)

    c2_of = hk_prefactor2(b, G)
    roots = [SignedRoot() for _ in range(3)]
    nt = int(task["num_steps"])
    sums = torch.zeros(2, nt, device=normals.device, dtype=cd)
    for step, (q, p, S, Z) in enumerate(trajectories(mol, task, b)):
        MqzU = torch.cat([Z[:, :d, :d] @ Ut, Z[:, :d, d:] @ Ut], dim=2)
        MpqU, MppU = Z[:, d:, :d] @ Ut, Z[:, d:, d:] @ Ut
        MpzU = torch.cat([MpqU, MppU], dim=2)
        MqpU = MqzU[:, :, r:]
        hessL = (1j / HBAR) * torch.cat([
            c(MpqU.transpose(1, 2) @ MqzU),
            c(MqpU.transpose(1, 2) @ MpzU)], dim=1)
        GtMqzU = t(Gt) @ MqzU
        A = (A_const[None] - hessL + c(MqzU.transpose(1, 2) @ GtMqzU)
             + 1j * (2.0 / HBAR) * c(MpzU.transpose(1, 2) @ MqzU))
        Abal = D @ (A / s_ab) @ D
        detA = torch.linalg.det(Abal)
        iA = D @ torch.linalg.inv(Abal) @ D / s_ab
        BQU = c(GtMqzU) + (1j / HBAR) * c(MpzU)
        Gt_t = Gt_c[None] - BQU @ (iA @ BQU.transpose(1, 2))
        Gti = BQU @ (iA @ BqU.T[None])
        Gti_iGi0 = Gti @ iGi0_c
        CQQ = Gt_t - Gti_iGi0 @ Gti.transpose(1, 2)
        CqQ = c(G0iGi0)[None] @ Gti.transpose(1, 2)
        PIQ = c(p) + (Gti_iGi0 @ dp0c[:, :, None])[:, :, 0]
        Mp = W[None] + Uc.T[None] @ CQQ @ Uc[None]
        detM = torch.linalg.det(Mp / m_scale)
        iM = torch.linalg.inv(Mp)
        CqQU = CqQ @ Uc
        Rqq = Cqq[None] - CqQU @ (iM @ CqQU.transpose(1, 2))
        iM_G0 = iM @ G0U.T[None]
        RQQ = G0_c[None] - G0U[None] @ iM_G0
        RqQ = CqQU @ iM_G0
        dPIQ_U = (PIQ - c(p0)[None]) @ Uc
        iM_dPIQ = (iM @ dPIQ_U[:, :, None])[:, :, 0]
        Pq = PIq - (CqQU @ iM_dPIQ[:, :, None])[:, :, 0]
        PQ = c(p0)[None] + iM_dPIQ @ G0U.T
        gamma = c(eps) - (0.5 / HBAR ** 2) * torch.sum(dPIQ_U * iM_dPIQ, 1)

        c2 = c2_of(Z)
        signs = [root.signs(z) for root, z in zip(roots, (c2, detA, detM))]
        dQ = c(q0[None] - q)
        expo = (gamma + c(b.logw_norm) - 0.5 * _bilinear(dq, Rqq, dq)
                - 0.5 * _bilinear(dQ, RQQ, dQ) + _bilinear(dq, RqQ, dQ)
                + 1j * (torch.sum(PQ * dQ, 1) - torch.sum(Pq * dq, 1))
                / HBAR)
        pref = (auto_pref * torch.sqrt(c2) * signs[0]
                * torch.polar(torch.ones_like(S), S / HBAR)
                * signs[1] / torch.sqrt(detA) * signs[2] / torch.sqrt(detM))
        x_c = pref * torch.exp(expo)
        nacqQ = _bilinear(n1, RqQ, n1)
        nacQ = (_bilinear(dQ, RQQ, n1) - _bilinear(dq, RqQ, n1)
                - 1j * torch.sum(PQ * n1, 1) / HBAR)
        nacq = (_bilinear(dq, Rqq, n1) - _bilinear(n1, RqQ, dQ)
                + 1j * torch.sum(Pq * n1, 1) / HBAR)
        x_k = (nacqQ + nacQ * nacq) * x_c / HBAR ** 2
        sums[0, step], sums[1, step] = x_c.sum(), x_k.sum()
    return b.finish(mol, task, sums)


def repetition(task, table, normals, dtype=torch.float64):
    """One repetition of the dynamics task `task` (WM; see
    `hk_dense.checked`); `table` is unused."""
    pot = checked(task, "WM")
    return run_plain(propagate, molecule(pot, normals.device), task,
                     normals, dtype)
