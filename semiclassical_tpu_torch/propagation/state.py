# coding: utf-8
"""Trajectory state and the branch-cut sign tracker.

The port keeps the four dense monodromy blocks stacked in one tensor
Z = [[Mqq, Mqp], [Mpq, Mpp]] of shape (n, 2d, 2d): the constant-Hessian RK4
step is one product T @ Z and the prefactor contracts Z directly, so the
blocks are only ever read as views.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["TrajState", "SignTracker"]


@dataclass(frozen=True)
class TrajState:
    """Classical trajectories plus monodromy (stability) matrices and action.

    q, p : (n, d)     positions / momenta
    Z : (n, 2d, 2d)   monodromy blocks  M_ab = d a(t) / d b(0), stacked
    S : (n,)          classical action integral of (T - V)
    """

    q: torch.Tensor
    p: torch.Tensor
    Z: torch.Tensor
    S: torch.Tensor

    @property
    def dim(self):
        return self.q.shape[1]

    @property
    def Mqq(self):
        d = self.dim
        return self.Z[:, :d, :d]

    @property
    def Mqp(self):
        d = self.dim
        return self.Z[:, :d, d:]

    @property
    def Mpq(self):
        d = self.dim
        return self.Z[:, d:, :d]

    @property
    def Mpp(self):
        d = self.dim
        return self.Z[:, d:, d:]

    @staticmethod
    def initial(q, p):
        """Monodromy = identity, action = 0."""
        n, d = q.shape
        Z = torch.eye(2 * d, dtype=q.dtype, device=q.device).expand(
            n, 2 * d, 2 * d).contiguous()
        S = torch.zeros(n, dtype=q.dtype, device=q.device)
        return TrajState(q=q, p=p, Z=Z, S=S)


@dataclass(frozen=True)
class SignTracker:
    """Branch-cut tracking state for sqrt(z(t)) along the propagation.

    sqrt has a branch cut on the negative real axis; to keep sqrt(z(t))
    continuous in time the sign flips whenever z crosses the cut. `previous`
    holds z(t - dt), `signs` the accumulated +-1 per trajectory.
    """

    previous: torch.Tensor  # (n,) complex  z at the previous evaluation
    signs: torch.Tensor     # (n,) real     accumulated sign of sqrt

    @staticmethod
    def fresh(z):
        return SignTracker(previous=z, signs=torch.ones_like(z.real))

    def update(self, z):
        """Advance the tracker to the new value z(t); returns the new tracker.

        The crossing condition is (Re z1 < 0) & (Re z2 < 0) & (Im z1 Im z2 < 0).
        """
        z1, z2 = self.previous, z
        cond = (z1.real < 0) & (z2.real < 0) & (z1.imag * z2.imag < 0)
        return SignTracker(previous=z,
                           signs=torch.where(cond, -self.signs, self.signs))

    def sqrt(self):
        """The sign-aligned square root of the current value."""
        return torch.sqrt(self.previous) * self.signs
