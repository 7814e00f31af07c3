# coding: utf-8
"""Coherent-state overlaps of multidimensional frozen Gaussians

    <x|q,p,G> = (det(G)/pi^N)^{1/4}
                exp(-1/2 (x-q)^T G (x-q) + i/hbar p^T (x-q))

The port of `semiclassical_tpu.coherent`: `OverlapParams`, the overlap
exponents and `overlap_vector` (the HK batch constants and the per-step
autocorrelation), the pair-overlap matrix of the O(n^2) norm
(`overlap_exponent_matrix`, `overlap_matrix`) and the grid wavefunction
(`WavefunctionParams`, `wavefunction`, `wavefunction_log`). The spectral
work on the constant width matrices happens once on the host
(`OverlapParams.create`); the device functions are batched with the
trajectory axis leading. A pack's real `dtype` (float64, or float32 in the
reduced-precision modes) is the precision of its exponents: the
displacements are taken at the inputs' precision, then cast to it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.units import hbar

__all__ = ["OverlapParams", "WavefunctionParams", "overlap_exponent_vector",
           "overlap_exponent_displaced",
           "overlap_vector", "overlap_exponent_matrix", "overlap_matrix",
           "wavefunction", "wavefunction_log"]


@dataclass(frozen=True)
class OverlapParams:
    """Constants for evaluating <qi,pi,Gi|qj,pj,Gj> overlaps."""

    Gi_iGij_Gj: torch.Tensor  # (d, d)   Gi [Gi+Gj]^{-1} Gj
    iGij: torch.Tensor        # (d, d)   pseudo-inverse of Gi+Gj
    Gj_iGij: torch.Tensor     # (d, d)   Gj [Gi+Gj]^{-1}
    fac: complex              # normalisation prefactor
    rank: int
    # (3, d) stack of the three matrices' diagonals when all of them are
    # exactly diagonal (diagonal widths): the exponent quadratic forms
    # are then elementwise products and a mode sum. None otherwise.
    diag_w: torch.Tensor | None = None

    @property
    def dtype(self):
        return self.Gi_iGij_Gj.dtype

    @staticmethod
    def create(Gi, Gj, device, dtype=torch.float64):
        Gi = np.asarray(Gi, dtype=np.float64)
        Gj = np.asarray(Gj, dtype=np.float64)
        if Gi.shape != Gj.shape:
            raise ValueError(
                "width matrices Gi and Gj have to have the same shape")
        ei, _ = linalg.sym_eigh(Gi)
        ej, _ = linalg.sym_eigh(Gj)
        ranki = int(np.count_nonzero(np.abs(ei) > linalg.ZERO))
        rankj = int(np.count_nonzero(np.abs(ej) > linalg.ZERO))
        if ranki != rankj:
            raise ValueError(
                "Gi and Gj have to have the same rank and null space.")
        detGi = np.prod(ei[np.abs(ei) > linalg.ZERO])
        detGj = np.prod(ej[np.abs(ej) > linalg.ZERO])

        Gij = Gi + Gj
        eij, Vij = linalg.sym_eigh(Gij)
        nz = np.abs(eij) > linalg.ZERO
        iGij = np.einsum("ij,j,kj->ik", Vij[:, nz], 1.0 / eij[nz], Vij[:, nz])
        detGij = np.prod(eij[nz])

        fac = np.sqrt(
            2.0**ranki * np.sqrt(detGi + 0j) * np.sqrt(detGj + 0j) / detGij
        )
        m1, m2, m3 = Gi @ iGij @ Gj, iGij, Gj @ iGij
        offdiag = max(float(np.abs(m - np.diag(np.diag(m))).max())
                      for m in (m1, m2, m3))
        diag_w = (np.stack([np.diag(m) for m in (m1, m2, m3)])
                  if offdiag == 0.0 else None)
        return OverlapParams.from_arrays(m1, m2, m3, complex(fac), ranki,
                                         device, diag_w=diag_w, dtype=dtype)

    @staticmethod
    def from_arrays(Gi_iGij_Gj, iGij, Gj_iGij, fac, rank, device,
                    diag_w=None, dtype=torch.float64):
        t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                   device=device, dtype=dtype)
        return OverlapParams(Gi_iGij_Gj=t(Gi_iGij_Gj), iGij=t(iGij),
                             Gj_iGij=t(Gj_iGij), fac=complex(fac),
                             rank=int(rank),
                             diag_w=None if diag_w is None else t(diag_w))


def _quad(x, A, y):
    """sum_ab x_na A_ab y_nb for batches x, y of shape (n, d)."""
    return torch.sum((x @ A) * y, dim=-1)


def overlap_exponent_vector(ov: OverlapParams, qi, pi, qj, pj):
    """(re, im) exponent parts of <qi(n),pi(n),Gi|qj,pj,Gj> for a batch of
    bra states qi, pi (n, d) and one ket qj, pj (d,), at the pack's
    dtype."""
    return overlap_exponent_displaced(ov, qj[None, :] - qi, pj[None, :] - pi,
                                      pj)


def overlap_exponent_displaced(ov: OverlapParams, dq, dp, pj):
    """(re, im) exponent parts from the displacements dq = qj - qi, dp =
    pj - pi (n, d) and the ket momentum pj (d,), cast to the pack's dtype:
    for callers that form the displacements themselves (the comp32 mode
    folds its residuals into them)."""
    t = ov.dtype
    dq, dp, pj = dq.to(t), dp.to(t), pj.to(t)
    if ov.diag_w is not None:
        w1, w2, w3 = ov.diag_w
        re_part = (-0.5 * torch.sum(dq * w1 * dq, dim=-1)
                   - (0.5 / hbar**2) * torch.sum(dp * w2 * dp, dim=-1))
        im_part = (torch.sum(dq * w3 * dp, dim=-1) - dq @ pj) / hbar
        return re_part, im_part
    re_part = (-0.5 * _quad(dq, ov.Gi_iGij_Gj, dq)
               - (0.5 / hbar**2) * _quad(dp, ov.iGij, dp))
    im_part = (_quad(dq, ov.Gj_iGij, dp) - dq @ pj) / hbar
    return re_part, im_part


def overlap_vector(ov: OverlapParams, qi, pi, qj, pj):
    """<qi(n),pi(n),Gi|qj,pj,Gj> for a batch of bra states and one ket,
    complex (n,)."""
    re, im = overlap_exponent_vector(ov, qi, pi, qj, pj)
    return ov.fac * torch.polar(torch.exp(re), im)


def overlap_exponent_matrix(ov: OverlapParams, qi, pi, qj, pj):
    """(re, im) exponent parts of the pair-overlap matrix <qi(i)|qj(j)>,
    (ni, nj) each, at the pack's dtype — for callers that fold log-scale
    factors (the log-coefficients of the norm) into the exponent before
    exponentiating.

    The quadratic forms are expanded, so the pair structure reduces to
    per-vector diagonals plus (ni, d) @ (d, nj) matmuls: O(ni nj d) matmul
    work in O(ni nj) memory, with no (ni, nj, d) displacement tensor."""
    t = ov.dtype
    qi, pi, qj, pj = qi.to(t), pi.to(t), qj.to(t), pj.to(t)
    A = ov.Gi_iGij_Gj
    B = ov.iGij / hbar**2
    C = ov.Gj_iGij
    Aqj, Bpj, Cpj = qj @ A.T, pj @ B.T, pj @ C.T       # (nj, d)
    Cpi = pi @ C.T                                      # (ni, d)

    # -1/2 (qj-qi)^T A (qj-qi) - 1/(2 hbar^2) (pj-pi)^T B (pj-pi)
    aq_ii = torch.sum(qi * (qi @ A.T), dim=1)
    aq_jj = torch.sum(qj * Aqj, dim=1)
    bp_ii = torch.sum(pi * (pi @ B.T), dim=1)
    bp_jj = torch.sum(pj * Bpj, dim=1)
    re = (-0.5 * (aq_ii[:, None] + aq_jj[None, :] - 2.0 * qi @ Aqj.T)
          - 0.5 * (bp_ii[:, None] + bp_jj[None, :] - 2.0 * pi @ Bpj.T))

    # [-pj.(qj-qi) + (qj-qi)^T C (pj-pi)] / hbar, fully expanded:
    #   (qj C pj - qj pj)[j] + qi.pj[i,j] - (qj C pi)[j,i] - (qi C pj)[i,j]
    #   + (qi C pi)[i]
    qcp_jj = torch.sum(qj * Cpj, dim=1)
    qcp_ii = torch.sum(qi * Cpi, dim=1)
    qp_jj = torch.sum(qj * pj, dim=1)
    im = ((qcp_jj - qp_jj)[None, :] + qi @ pj.T - (qj @ Cpi.T).T
          - qi @ Cpj.T + qcp_ii[:, None]) / hbar
    return re, im


def overlap_matrix(ov: OverlapParams, qi, pi, qj, pj):
    """The pair-overlap matrix <qi(i)|qj(j)>, complex (ni, nj)."""
    re, im = overlap_exponent_matrix(ov, qi, pi, qj, pj)
    return ov.fac * torch.polar(torch.exp(re), im)


@dataclass(frozen=True)
class WavefunctionParams:
    """Constants for superpositions of frozen Gaussians on grids."""

    G: torch.Tensor   # (d, d)
    fac: float        # (det G / pi^rank)^{1/4}
    rank: int

    @staticmethod
    def create(G, device, dtype=torch.float64):
        G = np.asarray(G, dtype=np.float64)
        e, _ = linalg.sym_eigh(G)
        nz = np.abs(e) > linalg.ZERO
        rank = int(np.count_nonzero(nz))
        fac = (np.prod(e[nz]) / np.pi**rank) ** 0.25
        return WavefunctionParams.from_arrays(G, fac, rank, device, dtype)

    @staticmethod
    def from_arrays(G, fac, rank, device, dtype=torch.float64):
        return WavefunctionParams(
            G=torch.tensor(np.asarray(G, dtype=np.float64), device=device,
                           dtype=dtype),
            fac=float(fac), rank=int(rank))


def _grid_exponent(wf: WavefunctionParams, q, p, x):
    """(re, im) of the Gaussians' exponents <x|q_i, p_i>, (n, nx) each, at
    the wider of the pack's and the inputs' precision."""
    dx = x[None, :, :] - q[:, None, :]                      # (n, nx, d)
    t = torch.promote_types(dx.dtype, wf.G.dtype)
    dx = dx.to(t)
    re = -0.5 * torch.einsum("nxa,ab,nxb->nx", dx, wf.G.to(t), dx)
    im = torch.einsum("na,nxa->nx", p.to(t), dx) / hbar
    return re, im


def wavefunction(wf: WavefunctionParams, q, p, v, x):
    """phi(x) = sum_i v_i <x|q_i,p_i> on a spatial grid.

    q, p : (n, d); v : complex (n,); x : (nx, d). Returns complex (nx,)."""
    re, im = _grid_exponent(wf, q, p, x)
    return torch.einsum("n,nx->x", v, wf.fac * torch.polar(torch.exp(re), im))


def wavefunction_log(wf: WavefunctionParams, q, p, log_v, x):
    """phi(x) from log-coefficients (log |v|, arg v): each trajectory's
    log |v| joins its Gaussian exponent and the trajectory sum is
    exponent-shifted, so the evaluation works where the linear
    coefficients over/underflow. Returns (psi_shifted (nx,) complex,
    zmax (nx,) real): phi = psi_shifted * exp(zmax), recombined by the
    caller on the host."""
    log_re, log_im = log_v
    rd = wf.G.dtype
    re, im = _grid_exponent(wf, q, p, x)
    Zre = log_re.to(rd)[:, None] + re + float(np.log(abs(wf.fac)))
    Zim = log_im.to(rd)[:, None] + im
    zmax = torch.max(Zre, dim=0).values                     # (nx,)
    psi = torch.sum(linalg.complex_exp(Zre - zmax[None, :], Zim,
                                       linalg.complex_dtype(rd)), dim=0)
    return psi, zmax
