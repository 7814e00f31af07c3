"""Plain pieces of a molecular configuration: the Gaussian formatted
checkpoint's fields, the excited state's vibrational ground state (the
initial wavepacket), and the sGDML force field (kernel-ridge regression,
Matern-5/2 kernel over inverse-distance descriptors) with its analytic
gradient and Hessian, and the minimum that fixes the energy origin.
NumPy on the host, PyTorch for the batched force field."""

import math
import re

import numpy as np
import torch

from reference.common import HBAR

AMU_TO_AUMASS = 1822.888486192


def read_fchk(path):
    """{field: value} of a formatted checkpoint: arrays of the I and R
    fields with an N= count, scalars of the others."""
    data, field, kind, acc = {}, None, None, []

    def flush():
        if field is not None and acc:
            data[field] = np.array(" ".join(acc).split(), dtype=kind)

    with open(path) as f:
        for line in f:
            if re.match(r"^[A-Z]", line):
                flush()
                field, acc = None, []
                if len(line) < 43 or line[43] not in "IR":
                    continue
                kind = int if line[43] == "I" else float
                if line[47:49] == "N=":
                    field = line[0:43].strip()
                else:
                    data[line[0:43].strip()] = kind(line[49:])
            elif field is not None:
                acc.append(line)
    flush()
    return data


def masses(fchk):
    """Masses per Cartesian coordinate, multiples of the electron's."""
    return np.repeat(fchk["Real atomic weights"] * AMU_TO_AUMASS, 3)


def vibrational_groundstate(fchk):
    """(x0, Gamma_0, zero-point energy) of the harmonic ground state at the
    checkpoint's geometry: translations and rotations projected out of the
    mass-weighted Hessian, Gamma_0 = L L^T with L = hbar^-1/2 M^1/2 V w^1/2
    over the internal modes."""
    x0 = fchk["Current cartesian coordinates"]
    nat = fchk["Number of atoms"]
    hess = np.zeros((3 * nat, 3 * nat))
    row, col = np.tril_indices(3 * nat)
    hess[row, col] = fchk["Cartesian Force Constants"]
    hess[col, row] = hess[row, col]
    mass = masses(fchk)
    msq = np.sqrt(mass)
    imsq = 1.0 / msq
    hess_mwc = np.einsum("i,ij,j->ij", imsq, hess, imsq)
    _, V = np.linalg.eigh(hess_mwc)
    pos = x0.reshape(-1, 3)
    atom_masses = mass[::3]
    center = (atom_masses[:, None] * pos).sum(axis=0) / atom_masses.sum()
    r = pos - center
    inertia = np.zeros((3, 3))
    for m_a, r_a in zip(atom_masses, r):
        inertia += m_a * (np.dot(r_a, r_a) * np.eye(3) - np.outer(r_a, r_a))
    moments, axes = np.linalg.eigh(inertia)
    axes = axes.T
    dim = hess_mwc.shape[0]
    D = np.zeros_like(hess_mwc)
    mwc = msq.reshape((-1, 3)) * r
    for i in (0, 1, 2):
        D[i::3, i] = msq[i::3]
    nz = 3
    scale = np.max(np.abs(moments))
    for i in (0, 1, 2):
        if moments[i] > 1e-12 * max(scale, 1.0):
            D[:, nz] = np.cross(axes[i, :], mwc).reshape(-1)
            nz += 1
    for i in range(nz):
        D[:, i] /= np.linalg.norm(D[:, i])
    for n in range(nz, dim):           # Gram-Schmidt on the normal modes
        D[:, n] = V[:, n]
        for m in range(n):
            D[:, n] -= np.dot(D[:, m], D[:, n]) * D[:, m]
        D[:, n] /= np.linalg.norm(D[:, n])
    hess_internal = D.T @ hess_mwc @ D
    wi2, Vi = np.linalg.eigh(hess_internal[nz:, nz:])
    wi = np.sqrt(wi2)
    Vmw = D[:, nz:] @ Vi
    L = HBAR ** (-0.5) * np.einsum("i,ij,j->ij", msq, Vmw, np.sqrt(wi))
    return x0, L @ L.T, float(0.5 * HBAR * np.sum(wi))


class GDML:
    """The sGDML model of a trained model file (as sgdml saves it), its
    permutations expanded into the training descriptors. `forward` gives
    energy, gradient and Hessian of a batch of geometries; the Hessian's
    contractions run at `hess_dtype`."""

    def __init__(self, path, device, hess_dtype):
        model = dict(np.load(path, allow_pickle=True))
        n = int(model["z"].shape[0])
        R_desc = np.asarray(model["R_desc"], dtype=np.float64)
        alphas = np.asarray(model["R_d_desc_alpha"], dtype=np.float64)
        size = R_desc.shape[0]
        n_perms = int(model["perms"].shape[0])
        perm = np.asarray(model["tril_perms_lin"]).reshape(-1, n_perms).T

        def expand(xs):
            return np.tile(xs, (1, n_perms))[:, perm.ravel()].reshape(-1,
                                                                       size)

        k, l = np.tril_indices(n, k=-1)
        inc = np.zeros((size, n))
        inc[np.arange(size), k] = 1.0
        inc[np.arange(size), l] = -1.0
        t = lambda x: torch.tensor(x, dtype=torch.float64, device=device)
        self.z = np.asarray(model["z"])
        self.xs_train, self.A = t(expand(R_desc.T)), t(expand(alphas))
        self.k = torch.tensor(k, device=device)
        self.l = torch.tensor(l, device=device)
        self.inc = t(inc)
        self.outer = t(inc[:, :, None] * inc[:, None, :])
        self.sig, self.c = float(model["sig"]), float(model["c"])
        self.std = float(model.get("std", 1.0))
        self.n = n
        self.hess_dtype = hess_dtype

    def forward(self, r, order=2):
        """(energy (B,), gradient (B, 3N)[, Hessian (B, 3N, 3N)]) at the
        Cartesian geometries r (B, 3N), bohr and hartree."""
        N, B = self.n, r.shape[0]
        xt, A = self.xs_train, self.A
        r3 = r.to(torch.float64).reshape(B, N, 3)
        q = math.sqrt(5.0) / self.sig
        diffs = r3[:, self.k, :] - r3[:, self.l, :]
        xs = 1.0 / torch.sqrt(torch.sum(diffs * diffs, dim=-1))
        sq_b = torch.sum(xs * xs, dim=1)
        sq_t = torch.sum(xt * xt, dim=1)
        x_dists = torch.sqrt(torch.clamp_min(
            sq_b[:, None] + sq_t[None, :] - 2.0 * (xs @ xt.T), 1e-20))
        XA = xs @ A.T - torch.sum(xt * A, dim=1)[None, :]
        exp_fac = (1.0 / 3.0) * q ** 4 * torch.exp(-q * x_dists)
        base = exp_fac * (1.0 + q * x_dists) / q ** 2
        energy = torch.sum(base * XA, dim=1) * self.std + self.c
        w = exp_fac * XA
        grad_x = base @ A - (torch.sum(w, dim=1)[:, None] * xs - w @ xt)
        xs3 = xs ** 3
        grad = -torch.einsum("bdc,da->bac",
                             (grad_x * xs3)[:, :, None] * diffs, self.inc)
        grad = grad.reshape(B, 3 * N) * self.std
        if order == 1:
            return energy, grad
        ht = self.hess_dtype
        h = lambda a: a.to(ht)
        xs_h, xs3_h, diffs_h = h(xs), h(xs3), h(diffs)
        exp_h, XA_h, gx_h, inc_h = h(exp_fac), h(XA), h(grad_x), h(self.inc)
        jac = -(xs3_h[:, :, None, None] * diffs_h[:, :, None, :]
                * inc_h[None, :, :, None]).reshape(B, -1, 3 * N)
        x_diffs = xs_h[:, None, :] - h(xt)[None]
        if ht != torch.float64:
            x_dists_h = h(x_dists)
        else:
            x_dists_h = torch.clamp_min(
                torch.sqrt(torch.sum(x_diffs * x_diffs, dim=-1)), 1e-10)
        XJ = torch.matmul(x_diffs, jac)
        AJ = torch.matmul(h(A), jac)
        JJ = torch.matmul(jac.transpose(1, 2), jac)
        q_h = float(torch.tensor(q, dtype=ht))     # q rounded to ht
        w1 = exp_h * XA_h * (q_h / x_dists_h)
        hess = torch.matmul((w1[:, :, None] * XJ).transpose(1, 2), XJ)
        hess = hess - torch.sum(exp_h * XA_h, dim=1)[:, None, None] * JJ
        cross = torch.matmul((exp_h[:, :, None] * AJ).transpose(1, 2), XJ)
        hess = hess - cross - cross.transpose(1, 2)
        W = h(self.outer).reshape(-1, N * N)
        h1 = (3.0 * (gx_h * xs_h ** 5)[:, :, None, None]
              * diffs_h[:, :, :, None] * diffs_h[:, :, None, :])
        corr1 = torch.matmul(h1.reshape(B, -1, 9).transpose(1, 2), W)
        corr1 = corr1.reshape(B, 3, 3, N, N).permute(0, 3, 1, 4, 2)
        corr2 = ((-gx_h * xs3_h) @ W).reshape(B, N, N)
        eye3 = torch.eye(3, dtype=ht, device=r.device)
        corr = corr1 + corr2[:, :, None, :, None] * eye3[None, None, :, None, :]
        hess = hess + corr.reshape(B, 3 * N, 3 * N)
        return energy, grad, hess * self.std


def minimum_energy(model, r_guess, maxiter=200, rtol=1.0e-5, gtol=1.0e-7):
    """The energy at the force field's minimum near `r_guess`: Newton
    steps on the pseudo-inverse of the Hessian (the rigid-body modes
    dropped), steepest descent where Newton does not descend, Armijo
    backtracking."""
    dev = model.xs_train.device

    def expansion(r):
        rt = torch.as_tensor(r, dtype=torch.float64, device=dev)[None, :]
        v, g, hs = model.forward(rt)
        return float(v[0]), g[0].cpu().numpy(), hs[0].cpu().numpy()

    r = np.asarray(r_guess, dtype=np.float64)
    for _ in range(maxiter):
        energy, g, hs = expansion(r)
        ev, evec = np.linalg.eigh(0.5 * (hs + hs.T))
        keep = np.abs(ev) > 1.0e-8 * np.abs(ev).max()
        dr = -(evec[:, keep] / ev[keep]) @ (evec[:, keep].T @ g)
        descent = float(np.sum(g * dr))
        if descent > 0.0:
            dr = -g
            descent = float(np.sum(g * dr))
        if np.linalg.norm(g) < gtol or np.linalg.norm(dr) < rtol:
            break
        a = 1.0
        for _ in range(100):
            r_try = r + a * dr
            if expansion(r_try)[0] <= energy + 1.0e-4 * a * descent:
                break
            a *= 0.3
        else:
            raise RuntimeError("line search failed")
        r = r_try
    else:
        raise RuntimeError("no minimum within maxiter iterations")
    return expansion(r)[0]
