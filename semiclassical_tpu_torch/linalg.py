# coding: utf-8
"""Linear algebra helpers.

* **Host-side (numpy)** spectral decompositions of the small, constant width
  matrices Gamma (symmetric sqrtm, pseudo-inverses, pseudo-determinants,
  null-space projectors) — the same functions as the host half of
  `semiclassical_tpu.linalg`. They run once per propagator construction, so
  the rank of Gamma is a Python int and the null-space projector U a fixed
  (d, r) matrix.
* **Device-side** `batched_det`, the per-step determinant of the HK
  prefactor matrices, which goes to the hand-written kernel in `ops.det`.
"""

from __future__ import annotations

import numpy as np

from semiclassical_tpu_torch.ops import det as _det_ops

# small float, threshold for considering eigenvalues as 0
ZERO = 1.0e-8

__all__ = [
    "ZERO",
    "sym_eigh",
    "sym_sqrtm",
    "is_symmetric_non_negative",
    "pseudo_inverse",
    "pseudo_det",
    "pseudo_logdet",
    "nonzero_subspace",
    "batched_det",
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


def batched_det(A):
    """Determinant of a batch of complex matrices, shape (n, r, r): the
    CUDA kernel for a tensor on the card, its plain version on the CPU
    (see `ops.det.batched_det`)."""
    return _det_ops.batched_det(A)
