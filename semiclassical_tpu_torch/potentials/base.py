# coding: utf-8
"""Structured Hessian operators for the monodromy equations of motion.

The equations of motion contract the local Hessian with the monodromy
blocks (dM_pq/dt = -H M_qq, dM_pp/dt = -H M_qp). The operator's class tells
the propagator which monodromy representation and integrator step apply:
a `ConstHessian` (harmonic molecular PES) gives the dense monodromy with
the constant RK4 step map, a `DiagHessian` (separable PES) the diagonal
monodromy, a `DenseHessian` (sGDML) the per-trajectory dense chain.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["DiagHessian", "DenseHessian", "ConstHessian"]


@dataclass(frozen=True)
class DiagHessian:
    """Diagonal Hessian batch, stored as (n, d)."""

    diag: torch.Tensor

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        """H @ M for monodromy blocks M of shape (n, d, d), or (n, d) in
        the diagonal-monodromy representation."""
        h = self.diag.to(M.dtype)
        return h * M if M.dim() == 2 else h[:, :, None] * M

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """H @ v for a batch of vectors v of shape (n, d)."""
        return self.diag.to(v.dtype) * v


@dataclass(frozen=True)
class DenseHessian:
    """Dense Hessian batch, stored as (n, d, d)."""

    mat: torch.Tensor

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.mat.to(M.dtype), M)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.mat.to(v.dtype), v[:, :, None])[:, :, 0]

    def dense(self) -> torch.Tensor:
        """The (n, d, d) matrices."""
        return self.mat


@dataclass(frozen=True)
class ConstHessian:
    """Geometry-independent Hessian (harmonic molecular PES), stored (d, d)
    and shared across the batch."""

    mat: torch.Tensor

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.mat.to(M.dtype), M)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return v @ self.mat.to(v.dtype).T

    def dense(self) -> torch.Tensor:
        """The matrix as a batch of one, (1, d, d)."""
        return self.mat[None]
