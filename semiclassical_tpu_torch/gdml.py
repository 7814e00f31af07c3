# coding: utf-8
"""sGDML force field with analytic batched Hessians — the port of
`semiclassical_tpu.gdml`.

Kernel-ridge regression with a Matern-5/2 kernel over inverse-distance
descriptors, symmetry permutations baked into expanded training tensors.
The arithmetic is the JAX package's, contraction for contraction:

* the kernel distances come from the Gram expansion
  ||a - b||^2 = |a|^2 + |b|^2 - 2 a.b (floor 1e-20 under the square root),
  so the energy and gradient paths are matmuls with O(B M + B D) memory;
* the Hessian path builds the explicit (B, M, D) descriptor differences at
  the Hessian's dtype; in the mixed mode (f64 pack, `hess_dtype` float32)
  it reuses the f64 Gram-expansion distances, otherwise it takes the norm
  of the differences with a 1e-10 floor;
* the descriptor-curvature corrections accumulate through the constant
  pair-incidence tensor W_d = u_d u_d^T (`pair_outer`), a matmul over the
  descriptor axis instead of a scatter.

These are plain contractions (`torch.matmul` / `torch.einsum`); the JAX
package has no Pallas kernel here either.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["GDMLParams", "gdml_forward"]


@dataclass(frozen=True)
class GDMLParams:
    """Trained sGDML model, permutation-expanded, on one device.

    Shapes: M = n_train * n_perms, D = N (N - 1) / 2 descriptor entries.
    """

    xs_train: torch.Tensor    # (M, D)  training descriptors (expanded)
    Jx_alphas: torch.Tensor   # (M, D)  regression coefficients (expanded)
    pair_k: torch.Tensor      # (D,) int64  first atom of each pair
    pair_l: torch.Tensor      # (D,) int64  second atom (k > l)
    incidence: torch.Tensor   # (D, N)  u_d = e_k - e_l
    pair_outer: torch.Tensor  # (D, N, N)  W_d = u_d u_d^T
    sig: float                # kernel length scale
    c: float                  # energy offset
    std: float                # energy scale
    n_atoms: int

    @staticmethod
    def from_npz(model, device, dtype=torch.float64, eg_mode="f64"):
        """Build from a trained sGDML model mapping (as saved by
        sgdml.train): 'sig', 'c', optional 'std', 'z', 'perms',
        'tril_perms_lin', 'R_desc' (D, n_train), 'R_d_desc_alpha'.

        `eg_mode` "ozaki" (the JAX package's error-free bf16 slicing of the
        energy/gradient contractions, a TPU device) is accepted and runs the
        f64 arithmetic: the card has f64 matmuls."""
        if eg_mode not in ("f64", "ozaki"):
            raise ValueError(f"unknown eg_mode {eg_mode!r} "
                             "(expected 'f64' or 'ozaki')")
        if eg_mode == "ozaki":
            logger.info("eg_mode 'ozaki' runs the f64 energy/gradient "
                        "contractions in this package")
        model = dict(model)
        n_atoms = int(model["z"].shape[0])
        R_desc = np.asarray(model["R_desc"], dtype=np.float64)      # (D, M0)
        R_d_desc_alpha = np.asarray(np.array(model["R_d_desc_alpha"]),
                                    dtype=np.float64)               # (M0, D)
        desc_siz = R_desc.shape[0]
        n_perms = int(model["perms"].shape[0])
        # tril_perms_lin holds, for each permutation, the linearised
        # permutation of descriptor entries
        perm_idxs = np.asarray(model["tril_perms_lin"]).reshape(
            -1, n_perms).T

        def expand(xs):  # (M0, D) -> (M0 * P, D)
            tiled = np.tile(xs, (1, n_perms))[:, perm_idxs.ravel()]
            return tiled.reshape(-1, desc_siz)

        k, l = np.tril_indices(n_atoms, k=-1)
        incidence = np.zeros((desc_siz, n_atoms))
        incidence[np.arange(desc_siz), k] = 1.0
        incidence[np.arange(desc_siz), l] = -1.0
        t = lambda x: torch.tensor(x, dtype=dtype, device=device)
        return GDMLParams(
            xs_train=t(expand(R_desc.T)),
            Jx_alphas=t(expand(R_d_desc_alpha)),
            pair_k=torch.tensor(k, device=device),
            pair_l=torch.tensor(l, device=device),
            incidence=t(incidence),
            pair_outer=t(incidence[:, :, None] * incidence[:, None, :]),
            sig=float(model["sig"]), c=float(model["c"]),
            std=float(model.get("std", 1.0)), n_atoms=n_atoms)


def gdml_forward(params: GDMLParams, r: torch.Tensor, order: int = 2,
                 hess_dtype=None):
    """Energy / gradient / Hessian for a batch of geometries.

    r : (B, 3N) cartesian coordinates in bohr. order 0 -> energy, 1 ->
    (energy, grad), 2 -> (energy, grad, hess). `hess_dtype` (a torch
    dtype, default the pack's) is the precision of the second-derivative
    contractions; energies and gradients always run at the pack's.

    Returns energy (B,), grad (B, 3N), hess (B, 3N, 3N) in atomic units.
    """
    N = params.n_atoms
    B = r.shape[0]
    xs_train, A = params.xs_train, params.Jx_alphas
    dt = xs_train.dtype
    r = r.to(dt)
    r3 = r.reshape(B, N, 3)
    q = math.sqrt(5.0) / params.sig

    diffs = r3[:, params.pair_k, :] - r3[:, params.pair_l, :]  # (B, D, 3)
    dists = torch.sqrt(torch.sum(diffs * diffs, dim=-1))       # (B, D)
    xs = 1.0 / dists

    # Gram expansion of the kernel distances; the floor keeps x_dists > 0
    # when the query IS a training geometry
    sq_b = torch.sum(xs * xs, dim=1)                           # (B,)
    sq_t = torch.sum(xs_train * xs_train, dim=1)               # (M,)
    gram = xs @ xs_train.T                                     # (B, M)
    x_dists = torch.sqrt(torch.clamp_min(
        sq_b[:, None] + sq_t[None, :] - 2.0 * gram, 1e-20))    # (B, M)

    tA = torch.sum(xs_train * A, dim=1)                        # (M,)
    XA = xs @ A.T - tA[None, :]                                # (B, M)

    exp_fac = (1.0 / 3.0) * q**4 * torch.exp(-q * x_dists)     # (B, M)
    mat52_base = exp_fac * (1.0 + q * x_dists) / q**2
    energy = torch.sum(mat52_base * XA, dim=1) * params.std + params.c
    if order == 0:
        return energy

    # gradient in descriptor space: a row-sum rescale of xs minus a
    # (B, M) @ (M, D) matmul
    w = exp_fac * XA
    grad_x = mat52_base @ A
    grad_x = grad_x - (torch.sum(w, dim=1)[:, None] * xs - w @ xs_train)
    xs3 = xs**3
    # jac[b, d, a, :] = -xs^3 diffs[b, d, :] U[d, a], contracted away
    g_pair = (grad_x * xs3)[:, :, None] * diffs                # (B, D, 3)
    grad = -torch.einsum("bdc,da->bac", g_pair, params.incidence)
    grad = grad.reshape(B, 3 * N) * params.std
    if order == 1:
        return energy, grad

    ht = hess_dtype if hess_dtype is not None else dt
    cast = lambda a: a.to(ht)
    xs_h, xs3_h, diffs_h = cast(xs), cast(xs3), cast(diffs)
    exp_fac_h, XA_h, grad_x_h = cast(exp_fac), cast(XA), cast(grad_x)
    incidence_h = cast(params.incidence)

    # dense descriptor Jacobian (B, D, 3N)
    jac = -(xs3_h[:, :, None, None] * diffs_h[:, :, None, :]
            * incidence_h[None, :, :, None]).reshape(B, -1, 3 * N)

    # explicit descriptor differences at the Hessian dtype (the expanded
    # form breaches the mixed-Hessian accuracy, see the JAX package)
    x_diffs_h = xs_h[:, None, :] - cast(xs_train)[None]         # (B, M, D)
    if dt == torch.float64 and ht != torch.float64:
        # mixed mode: the f64 Gram-expansion distances are the more
        # accurate ones (same floor)
        x_dists_h = cast(x_dists)
    else:
        x_dists_h = torch.clamp_min(
            torch.sqrt(torch.sum(x_diffs_h * x_diffs_h, dim=-1)), 1e-10)

    XJ = torch.matmul(x_diffs_h, jac)                          # (B, M, 3N)
    AJ = torch.matmul(cast(A), jac)                            # (B, M, 3N)
    JJ = torch.matmul(jac.transpose(1, 2), jac)                # (B, 3N, 3N)

    q_h = torch.tensor(q, dtype=ht, device=r.device)
    w1 = exp_fac_h * XA_h * (q_h / x_dists_h)
    hess = torch.matmul((w1[:, :, None] * XJ).transpose(1, 2), XJ)
    hess = hess - torch.sum(exp_fac_h * XA_h, dim=1)[:, None, None] * JJ
    cross = torch.matmul((exp_fac_h[:, :, None] * AJ).transpose(1, 2), XJ)
    hess = hess - cross - cross.transpose(1, 2)

    # descriptor-curvature corrections through W_d = u_d u_d^T:
    #   corr1[b, a, u, c, v] = sum_d h1[b, d, u, v] W[d, a, c]
    #   corr2[b, a, c]       = sum_d h2[b, d] W[d, a, c]
    W = cast(params.pair_outer).reshape(-1, N * N)             # (D, N^2)
    h1 = (3.0 * (grad_x_h * xs_h**5)[:, :, None, None]
          * diffs_h[:, :, :, None] * diffs_h[:, :, None, :])    # (B, D, 3, 3)
    h2 = -grad_x_h * xs3_h                                      # (B, D)
    corr1 = torch.matmul(h1.reshape(B, -1, 9).transpose(1, 2), W)
    corr1 = corr1.reshape(B, 3, 3, N, N).permute(0, 3, 1, 4, 2)
    corr2 = (h2 @ W).reshape(B, N, N)
    eye3 = torch.eye(3, dtype=ht, device=r.device)
    corr = corr1 + corr2[:, :, None, :, None] * eye3[None, None, :, None, :]
    hess = hess + corr.reshape(B, 3 * N, 3 * N)
    return energy, grad, hess * params.std
