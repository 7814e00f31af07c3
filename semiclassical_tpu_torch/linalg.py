# coding: utf-8
"""Linear algebra helpers.

* **Host-side (numpy)** spectral decompositions of the small, constant width
  matrices Gamma (symmetric sqrtm, pseudo-inverses, pseudo-determinants,
  null-space projectors) — the same functions as the host half of
  `semiclassical_tpu.linalg`. They run once per propagator construction, so
  the rank of Gamma is a Python int and the null-space projector U a fixed
  (d, r) matrix.
* **Device-side** `logspace_mode_product`, the range-safe product over
  modes that the separable (diagonal) path uses for every determinant;
  `batched_det`, the per-step determinant of the HK prefactor matrices,
  which goes by its size r to one of two hand-written kernels: K1
  (`ops.det`: many matrices per warp with a row per lane in registers to
  r = 16, one warp per matrix in shared memory above) for r <=
  `DET_WARP_MAX_R`, K4 (`ops.det_block`, one thread block per matrix with
  the matrix in registers) above;
  and the WM eliminations `batched_det_inv`, `batched_det_solve` and
  `batched_det_solve_blocks`, which go to the Gauss-Jordan kernels of
  `ops.gj` at leaves of m <= 64 (the structure of the JAX package's lanes
  path: block-Schur levels above the leaf, block products as batched
  matmuls). K2 and K3 pick their own layouts by the leaf's shape
  (`ops.gj.solve_variant`: a warp per matrix for m <= 8, a thread block per
  matrix and column chunk with the matrix in registers above;
  `ops.gj.inv_variant`: many matrices per warp with a row per lane for
  m <= 16, a thread block per matrix above).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from semiclassical_tpu_torch.ops import det as _det_ops
from semiclassical_tpu_torch.ops import det_block as _det_block_ops
from semiclassical_tpu_torch.ops import gj as _gj_ops

logger = logging.getLogger(__name__)

# small float, threshold for considering eigenvalues as 0
ZERO = 1.0e-8

__all__ = [
    "ZERO",
    "DET_WARP_MAX_R",
    "sym_eigh",
    "sym_sqrtm",
    "is_symmetric_non_negative",
    "pseudo_inverse",
    "pseudo_det",
    "pseudo_logdet",
    "nonzero_subspace",
    "logspace_mode_product",
    "batched_det",
    "batched_det_inv",
    "batched_det_solve",
    "batched_det_solve_blocks",
]


def sym_eigh(A: np.ndarray):
    """Eigendecomposition of a real symmetric matrix, ascending eigenvalues."""
    A = np.asarray(A, dtype=np.float64)
    return np.linalg.eigh(A)


def sym_sqrtm(A: np.ndarray):
    """Square root of a symmetric real matrix and pseudo-inverse of the root.

    Returns (A^{1/2}, A^{+(-1/2)}) as complex arrays; negative eigenvalues are
    handled by the complex square root, zero eigenvalues (|e| <= ZERO) are
    excluded from the pseudo-inverse.
    """
    e, V = sym_eigh(A)
    non_zero = np.abs(e) > ZERO
    ec = e.astype(np.complex128)
    Vc = V.astype(np.complex128)
    sqA = np.einsum("ij,j,kj->ik", Vc, np.sqrt(ec), Vc)
    sqA_pinv = np.einsum(
        "ij,j,kj->ik",
        Vc[:, non_zero],
        1.0 / np.sqrt(ec[non_zero]),
        Vc[:, non_zero],
    )
    return sqA, sqA_pinv


def is_symmetric_non_negative(A: np.ndarray, eps: float = 1.0e-6) -> bool:
    """Check that A is symmetric and positive semi-definite."""
    A = np.asarray(A, dtype=np.float64)
    relerr = np.sum(np.abs(A - A.T)) / np.sum(np.abs(A))
    if relerr > eps:
        return False
    e, _ = np.linalg.eigh(A)
    return bool((e >= -ZERO).all())


def pseudo_inverse(A: np.ndarray) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of a symmetric matrix via eigh,
    dropping eigenvalues with |e| <= ZERO."""
    e, V = sym_eigh(A)
    nz = np.abs(e) > ZERO
    return np.einsum("ij,j,kj->ik", V[:, nz], 1.0 / e[nz], V[:, nz])


def pseudo_det(A: np.ndarray, scale: float = 1.0) -> float:
    """Pseudo-determinant: product of non-zero eigenvalues of symmetric A,
    each divided by `scale`."""
    e, _ = sym_eigh(A)
    nz = np.abs(e) > ZERO
    return float(np.prod(e[nz] / scale))


def pseudo_logdet(A: np.ndarray, scale: float = 1.0) -> float:
    """log of the pseudo-determinant of a PSD matrix (eigenvalues / scale).
    In many dimensions the pseudo-determinant itself under/overflows f64."""
    e, _ = sym_eigh(A)
    nz = e > ZERO
    return float(np.sum(np.log(e[nz] / scale)))


def nonzero_subspace(A: np.ndarray, positive_only: bool = True) -> np.ndarray:
    """Orthonormal basis U (d, r) of the non-zero eigenspace of symmetric A."""
    e, V = sym_eigh(A)
    nz = (e > ZERO) if positive_only else (np.abs(e) > ZERO)
    return np.ascontiguousarray(V[:, nz])


def logspace_mode_product(z_re, z_im, dim=1):
    """prod of (z_re + i z_im) over the mode axis `dim`, in log space:
    magnitudes as a sum of logs, phases as a sum of angles — range-safe at
    any mode count. The determinant of every diagonal-path matrix (the HK
    prefactor, WM's detA and detM)."""
    log_mag = 0.5 * torch.sum(torch.log(z_re**2 + z_im**2), dim=dim)
    ang = torch.sum(torch.atan2(z_im, z_re), dim=dim)
    return torch.polar(torch.exp(log_mag), ang)


# The size rule of `batched_det`: K1 to r = DET_WARP_MAX_R, K4 (a thread
# block per matrix) above, to r = 64 (methylium's r = 6 takes K1's rows
# kernel, coumarin's r = 45 K4). The constant is the crossing of K1's warp
# kernel and K4 measured on an H100 with the entry points called directly
# (`scripts/torch_kernel_compare.py --direct`, PERF.md): at (2048, r, r)
# and (10^4, r, r) complex128 K1 takes 45.7 and 210.1 us at r = 27 against
# K4's 54.0 and 231.0, and 58.9 and 242.5 us at r = 28 against 55.4 and
# 236.0; at r = 32 K4 is 1.5-1.7x faster.
DET_WARP_MAX_R = 27


def batched_det(A):
    """Determinant of a batch of complex matrices, shape (n, r, r): K1
    (`ops.det.batched_det`) for r <= DET_WARP_MAX_R, K4
    (`ops.det_block.batched_det_block`) above; each launches its CUDA
    kernel for a tensor on the card and runs the same plain elimination on
    the CPU."""
    if A.shape[-1] <= DET_WARP_MAX_R:
        return _det_ops.batched_det(A)
    return _det_block_ops.batched_det_block(A)


# Largest leaf the Gauss-Jordan kernels take; above it one block-Schur level
# per factor of 2 splits the matrix (as `semiclassical_tpu.linalg._GJ_LEAF`:
# the kernels' flops grow as m^3, so halving m at the cost of a few batched
# matmuls wins, and 2r = 120 at the 60-mode flagship splits into two r = 60
# leaves).
_GJ_LEAF = _gj_ops.MAX_M
# (m, k) of the K2 leaves seen so far, each logged once (K2 takes
# m + k <= `ops.gj.MAX_WIDTH`)
_K2_LEAVES = set()


def _det_inv_blocked(A):
    """(det, inv) of (n, m, m): K3 at the leaves, block-Schur above
    `_GJ_LEAF`."""
    m = A.shape[-1]
    if m <= _GJ_LEAF:
        return _gj_ops.batched_det_inv_gj(A.contiguous())
    r1 = m // 2
    A11, A12 = A[..., :r1, :r1], A[..., :r1, r1:]
    A21, A22 = A[..., r1:, :r1], A[..., r1:, r1:]
    det1, i11 = _det_inv_blocked(A11)
    i11_A12 = i11 @ A12
    det2, iS = _det_inv_blocked(A22 - A21 @ i11_A12)
    A21_i11 = A21 @ i11
    top_right = -i11_A12 @ iS
    inv = torch.cat([
        torch.cat([i11 - top_right @ A21_i11, top_right], dim=-1),
        torch.cat([-iS @ A21_i11, iS], dim=-1)], dim=-2)
    return det1 * det2, inv


def _det_solve(A, B):
    """(det A, A^{-1} B) for A (n, m, m), B (n, m, k): K2 at the leaves,
    block elimination above `_GJ_LEAF`."""
    m = A.shape[-1]
    if m <= _GJ_LEAF:
        if (m, B.shape[-1]) not in _K2_LEAVES:
            _K2_LEAVES.add((m, B.shape[-1]))
            logger.info(f"K2 leaf (m | k) = ({m} | {B.shape[-1]}), batch "
                        f"{A.shape[0]}")
        return _gj_ops.batched_det_solve_gj(A.contiguous(), B.contiguous())
    r1 = m // 2
    return batched_det_solve_blocks(A[..., :r1, :r1], A[..., :r1, r1:],
                                    A[..., r1:, :r1], A[..., r1:, r1:],
                                    B[..., :r1, :], B[..., r1:, :])


def batched_det_solve_blocks(A11, A12, A21, A22, B1, B2):
    """(det, [Y1; Y2]) of the 2x2-blocked system [[A11, A12], [A21, A22]]
    [Y1; Y2] = [B1; B2], batch (n, ...), by block elimination at every
    size, so callers that assemble the blocks natively (the WM A-matrix)
    never concatenate the full matrix:

        det1, [G | t] = A11^{-1} [A12 | B1]      (one K2 call)
        S = A22 - A21 G,  rhs2 = B2 - A21 t      (one batched matmul)
        det2, Y2 = S^{-1} rhs2                   (recurse)
        Y1 = t - G Y2                            (one batched matmul)
    """
    k12 = A12.shape[-1]
    det1, Gt = _det_solve(A11, torch.cat([A12, B1], dim=-1))
    G, t = Gt[..., :k12], Gt[..., k12:]
    A21Gt = A21 @ Gt
    det2, Y2 = _det_solve(A22 - A21Gt[..., :k12], B2 - A21Gt[..., k12:])
    return det1 * det2, torch.cat([t - G @ Y2, Y2], dim=-2)


def _flat(x):
    return x.reshape((-1,) + x.shape[-2:])


def batched_det_inv(A):
    """(det A, A^{-1}) of a batch of complex matrices (..., m, m), any
    number of leading batch dims: K3 (`ops.gj`) for m <= 64, block-Schur
    levels above."""
    det, inv = _det_inv_blocked(_flat(A))
    return det.reshape(A.shape[:-2]), inv.reshape(A.shape)


def batched_det_solve(A, B):
    """(det A, A^{-1} B) for A (..., m, m), B (..., m, k): K2 (`ops.gj`)
    for m <= 64, block elimination above."""
    det, Y = _det_solve(_flat(A), _flat(B))
    return det.reshape(A.shape[:-2]), Y.reshape(B.shape)
