# coding: utf-8
"""Analytic separable model potentials: `NonHarmonicPotential` and
`MorsePotential`, the port of `semiclassical_tpu.potentials.model`.

Both are sums of one-dimensional terms, so the Hessian is diagonal at every
geometry: `local_expansion` returns a `DiagHessian`, which selects the
diagonal monodromy representation and its per-mode RK4 map. All methods
take batches with the trajectory axis leading, q of shape (n, d), and run
at the parameters' dtype: `local_expansion` casts q to it, so float32
parameters (the reduced-precision modes) evaluate the PES at float32 under
float64 trajectories. `MorsePotential` carries the JAX package's
reduced-cost Hessian modes (`hessian_eval`, `taylor_every`), which
`eom.rk4_step` and the propagators' time loop read.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.potentials.base import DiagHessian

logger = logging.getLogger(__name__)

__all__ = ["NonHarmonicPotential", "MorsePotential"]


def _t(x, device, dtype=torch.float64):
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device,
                        dtype=dtype)


def _cast(potential, dtype):
    """A copy of `potential` with every tensor field at `dtype`."""
    return dataclasses.replace(potential, **{
        f.name: getattr(potential, f.name).to(dtype)
        for f in dataclasses.fields(potential)
        if isinstance(getattr(potential, f.name), torch.Tensor)})


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
    def create(eps=0.975, b=12.0 ** (-0.5), dim=1, device="cuda",
               dtype=torch.float64):
        return NonHarmonicPotential(eps=_t(np.full(dim, eps), device, dtype),
                                    b=_t(np.full(dim, b), device, dtype))

    def to_dtype(self, dtype):
        """The potential with its parameters at `dtype`."""
        return _cast(self, dtype)

    def dimensions(self) -> int:
        return self.eps.shape[0]

    def masses(self) -> torch.Tensor:
        return torch.ones_like(self.eps)

    def local_expansion(self, q):
        """(V (n,), grad (n, d), DiagHessian (n, d)) at positions q (n, d),
        at the parameters' dtype."""
        q = q.to(self.eps.dtype)
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

    def constant_coupling(self):
        """tau1 (d,): the first-order coupling, the same at every q, with
        tau2 = 0 (what the separable observe reads, `ops.observe`)."""
        return torch.ones_like(self.eps)


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

    `hessian_eval` selects the reduced-cost PES sampling of `eom.rk4_step`,
    the contract of the sGDML potential: "stage" (the default, every RK4
    stage evaluates the Hessian), "step" (the Hessian once per step at the
    midpoint stage, trajectories unchanged) or "taylor" (one evaluation
    per step at the free-flight midpoint, the stage forces from its local
    quadratic), with `taylor_every` > 1 re-expanding once per window of
    that many steps.
    """

    omega: torch.Tensor  # (d,)
    a: torch.Tensor      # (d,)
    D: torch.Tensor      # (d,)
    nac: torch.Tensor    # (d,)
    harmonic: bool       # all chi == 0
    hessian_eval: str = "stage"
    taylor_every: int = 1

    @staticmethod
    def create(omega, chi, nac, device="cuda", dtype=torch.float64,
               hessian_eval="stage", taylor_every=1):
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
        return MorsePotential.from_arrays(omega, a, D, nac, harmonic, device,
                                          dtype, hessian_eval, taylor_every)

    @staticmethod
    def from_arrays(omega, a, D, nac, harmonic, device, dtype=torch.float64,
                    hessian_eval="stage", taylor_every=1):
        """From the parameter arrays; `hessian_eval` and `taylor_every` are
        validated as the JAX package validates them."""
        if hessian_eval not in ("stage", "step", "taylor"):
            raise ValueError(f"unknown hessian_eval {hessian_eval!r}")
        taylor_every = int(taylor_every)
        if taylor_every < 1:
            raise ValueError("taylor_every must be >= 1")
        if taylor_every > 1 and hessian_eval != "taylor":
            raise ValueError(
                "taylor_every > 1 requires hessian_eval='taylor'")
        t = lambda x: _t(x, device, dtype)
        return MorsePotential(omega=t(omega), a=t(a), D=t(D), nac=t(nac),
                              harmonic=bool(harmonic),
                              hessian_eval=hessian_eval,
                              taylor_every=taylor_every)

    def to_dtype(self, dtype):
        """The potential with its parameters at `dtype`."""
        return _cast(self, dtype)

    def dimensions(self) -> int:
        return self.omega.shape[0]

    def masses(self) -> torch.Tensor:
        return torch.ones_like(self.omega)

    def local_expansion(self, q):
        """(V (n,), grad (n, d), DiagHessian (n, d)) at positions q (n, d),
        at the parameters' dtype."""
        q = q.to(self.omega.dtype)
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

    def constant_coupling(self):
        """tau1 (d,): the first-order coupling, the same at every q, with
        tau2 = 0 (what the separable observe reads, `ops.observe`)."""
        return self.nac
