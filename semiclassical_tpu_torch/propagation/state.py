# coding: utf-8
"""Trajectory state and the branch-cut sign tracker.

The port keeps the four dense monodromy blocks stacked in one tensor
Z = [[Mqq, Mqp], [Mpq, Mpp]] of shape (n, 2d, 2d): the constant-Hessian RK4
step is one product T @ Z and the prefactor contracts Z directly, so the
blocks are only ever read as views.

For a separable potential (diagonal Hessian at every geometry) the
monodromy that starts at the identity stays exactly diagonal, and the
*diagonal representation* keeps only the diagonals: Z of shape (4, n, d)
holding the planes [Mqq, Mqp, Mpq, Mpp], each a contiguous (n, d) block
that the per-mode RK4 map and the WM kernel read in place.

In the compensated-float32 mode ("comp32") q and p are float32 with float32
Neumaier residuals qc and pc (the true value is q + qc), S stays float64,
and every increment folds in through an exact two-sum
(`eom._comp_accumulate`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["TrajState", "SignTracker"]


@dataclass(frozen=True)
class TrajState:
    """Classical trajectories plus monodromy (stability) matrices and action.

    q, p : (n, d)     positions / momenta
    Z : (n, 2d, 2d)   monodromy blocks  M_ab = d a(t) / d b(0), stacked;
        or (4, n, d)  their diagonals [Mqq, Mqp, Mpq, Mpp] in the diagonal
                      representation
    S : (n,)          classical action integral of (T - V)
    qc, pc : (n, d)   the comp32 residuals of q and p (true value q + qc),
                      None in the plain modes
    """

    q: torch.Tensor
    p: torch.Tensor
    Z: torch.Tensor
    S: torch.Tensor
    qc: torch.Tensor | None = None
    pc: torch.Tensor | None = None

    @property
    def dim(self):
        return self.q.shape[1]

    @property
    def compensated(self):
        return self.qc is not None

    @property
    def diag_monodromy(self):
        """True in the diagonal representation: Z is (4, n, d) (a dense Z
        (n, 2d, 2d) never has trailing dimensions (n, d))."""
        return self.Z.shape[1:] == self.q.shape

    def _block(self, i, j):
        if self.diag_monodromy:
            return self.Z[2 * i + j]
        d = self.dim
        return self.Z[:, i * d:(i + 1) * d, j * d:(j + 1) * d]

    @property
    def Mqq(self):
        return self._block(0, 0)

    @property
    def Mqp(self):
        return self._block(0, 1)

    @property
    def Mpq(self):
        return self._block(1, 0)

    @property
    def Mpp(self):
        return self._block(1, 1)

    def dense_Z(self):
        """The stacked dense blocks (n, 2d, 2d), expanding the diagonal
        representation if active."""
        if not self.diag_monodromy:
            return self.Z
        n, d = self.q.shape
        Z = torch.zeros(n, 2, 2, d, d, dtype=self.Z.dtype,
                        device=self.Z.device)
        Z.diagonal(dim1=3, dim2=4).copy_(
            self.Z.view(2, 2, n, d).permute(2, 0, 1, 3))
        return Z.transpose(2, 3).reshape(n, 2 * d, 2 * d)

    @staticmethod
    def initial(q, p, dtype=None, mono_dtype=None, diag_monodromy=False,
                compensated=False):
        """Monodromy = identity, action = 0.

        `dtype` sets the precision of q, p and S, `mono_dtype` that of Z
        (default: the trajectories'); `diag_monodromy` selects the diagonal
        representation (valid only for separable potentials).
        `compensated` selects comp32: q and p are split into float32 values
        and float32 residuals of the float64 q and p given (`dtype` is
        ignored), and S is float64."""
        if compensated:
            q64, p64 = q.to(torch.float64), p.to(torch.float64)
            q, p = q64.to(torch.float32), p64.to(torch.float32)
            qc = (q64 - q.to(torch.float64)).to(torch.float32)
            pc = (p64 - p.to(torch.float64)).to(torch.float32)
            s_dtype = torch.float64
        else:
            if dtype is not None:
                q, p = q.to(dtype), p.to(dtype)
            qc = pc = None
            s_dtype = q.dtype
        mono_dtype = q.dtype if mono_dtype is None else mono_dtype
        n, d = q.shape
        if diag_monodromy:
            Z = torch.zeros(4, n, d, dtype=mono_dtype, device=q.device)
            Z[0::3] = 1.0
        else:
            Z = torch.eye(2 * d, dtype=mono_dtype, device=q.device).expand(
                n, 2 * d, 2 * d).contiguous()
        S = torch.zeros(n, dtype=s_dtype, device=q.device)
        return TrajState(q=q, p=p, Z=Z, S=S, qc=qc, pc=pc)


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
