# coding: utf-8
"""Analytic separable model potentials: `NonHarmonicPotential` and
`MorsePotential`, the port of `semiclassical_tpu.potentials.model`.

Both are sums of one-dimensional terms, so the Hessian is diagonal at every
geometry: `local_expansion` returns a `DiagHessian`, which selects the
diagonal monodromy representation and its per-mode RK4 map. All methods
take batches with the trajectory axis leading, q of shape (n, d), and run
at float64.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.potentials.base import DiagHessian

logger = logging.getLogger(__name__)

__all__ = ["NonHarmonicPotential", "MorsePotential"]


def _t(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


@dataclass(frozen=True)
class NonHarmonicPotential:
    """eps * Morse + (1 - eps) * harmonic oscillator (Herman-Kluk 1986 eqn. 7)

        V(x) = eps/(2 b^2) (1 - exp(-b x))^2 + (1 - eps) 1/2 x^2

    with the paper's parameters eps = 0.975, b = 12^{-1/2}.
    Unit masses; constant tau1 = 1, tau2 = 0.
    """

    eps: torch.Tensor  # (d,)
    b: torch.Tensor    # (d,)

    @staticmethod
    def create(eps=0.975, b=12.0 ** (-0.5), dim=1, device="cuda"):
        return NonHarmonicPotential(eps=_t(np.full(dim, eps), device),
                                    b=_t(np.full(dim, b), device))

    def dimensions(self) -> int:
        return self.eps.shape[0]

    def masses(self) -> torch.Tensor:
        return torch.ones_like(self.eps)

    def local_expansion(self, q):
        """(V (n,), grad (n, d), DiagHessian (n, d)) at positions q (n, d)."""
        eps, b = self.eps[None, :], self.b[None, :]
        ex = torch.exp(-b * q)
        v = torch.sum(eps / (2 * b**2) * (1.0 - ex) ** 2
                      + (1 - eps) * 0.5 * q**2, dim=1)
        grad = eps / b * (ex - ex**2) + (1 - eps) * q
        hdiag = eps * (2 * ex**2 - ex) + (1 - eps)
        return v, grad, DiagHessian(diag=hdiag)

    def derivative_coupling_1st(self, q):
        return torch.ones_like(q)

    def derivative_coupling_2nd(self, q):
        return torch.zeros_like(q)


@dataclass(frozen=True)
class MorsePotential:
    """N separable Morse modes with anharmonicity chi (DOI 10.1063/1.5143212
    eqn. 6).

        V(r) = sum_k D_k (1 - exp(-a_k r_k))^2
        a = sqrt(2 omega chi),  D = omega / (4 chi)

    chi = 0 modes are given a tiny anharmonicity (1e-4) so that all modes
    are describable by the same Morse form without changing results. Purely
    harmonic models (all chi = 0) use the closed-form harmonic branch,
    selected at construction. Unit masses; tau1 = nac (constant), tau2 = 0.
    The JAX package's reduced-cost Hessian modes (`hessian_eval`,
    `taylor_every`) are not ported: every stage evaluates the Hessian.
    """

    omega: torch.Tensor  # (d,)
    a: torch.Tensor      # (d,)
    D: torch.Tensor      # (d,)
    nac: torch.Tensor    # (d,)
    harmonic: bool       # all chi == 0

    @staticmethod
    def create(omega, chi, nac, device="cuda"):
        omega = np.asarray(omega, dtype=np.float64)
        chi = np.array(chi, dtype=np.float64, copy=True)
        nac = np.asarray(nac, dtype=np.float64)
        harmonic = bool((chi == 0.0).all())
        if harmonic:
            logger.info("Potential is harmonic.")
        else:
            chi[chi == 0.0] += 1.0e-4
        a = np.sqrt(2 * omega * chi)
        D = np.where(chi > 0, 0.25 * omega / np.where(chi > 0, chi, 1.0), 0.0)
        return MorsePotential.from_arrays(omega, a, D, nac, harmonic, device)

    @staticmethod
    def from_arrays(omega, a, D, nac, harmonic, device):
        return MorsePotential(omega=_t(omega, device), a=_t(a, device),
                              D=_t(D, device), nac=_t(nac, device),
                              harmonic=bool(harmonic))

    def dimensions(self) -> int:
        return self.omega.shape[0]

    def masses(self) -> torch.Tensor:
        return torch.ones_like(self.omega)

    def local_expansion(self, q):
        """(V (n,), grad (n, d), DiagHessian (n, d)) at positions q (n, d)."""
        if self.harmonic:
            om2 = (self.omega**2)[None, :]
            v = torch.sum(0.5 * om2 * q**2, dim=1)
            return v, om2 * q, DiagHessian(diag=om2.expand(q.shape))
        a, D = self.a[None, :], self.D[None, :]
        ex = torch.exp(-a * q)
        v = torch.sum(D * (1.0 - ex) ** 2, dim=1)
        grad = 2 * a * D * ex * (1.0 - ex)
        hdiag = 2 * a**2 * D * ex * (2 * ex - 1.0)
        return v, grad, DiagHessian(diag=hdiag)

    def derivative_coupling_1st(self, q):
        return self.nac[None, :].expand(q.shape)

    def derivative_coupling_2nd(self, q):
        return torch.zeros_like(q)
