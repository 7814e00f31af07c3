# coding: utf-8
"""Molecular harmonic potential energy surface.

`MolecularHarmonicPotential` is the second-order Taylor PES built from a
Gaussian 16 frequency checkpoint, with a constant Hessian and a constant
NAC vector (Condon approximation) — the port of the class of the same name
in `semiclassical_tpu.potentials.molecular`. `minimize` locates the PES
minimum by Newton steps with Armijo backtracking and returns a potential
whose energy origin sits there; that origin sets the phase of C(t) and the
adiabatic gap, so it is computed at f64 on the host.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.potentials.base import ConstHessian

logger = logging.getLogger(__name__)

__all__ = ["MolecularHarmonicPotential", "minimize"]


@dataclass(frozen=True)
class MolecularHarmonicPotential:
    """Harmonic expansion around a reference geometry (usually the minimum):

        V(r') = V0 + grad0^T (r' - r0) + 1/2 (r' - r0)^T hess0 (r' - r0)

    All fields are float64 tensors on one device; `origin` is the energy
    origin set by `minimize` (a Python float).
    """

    pos0: torch.Tensor     # (d,)
    energy0: float
    grad0: torch.Tensor    # (d,)
    hess0: torch.Tensor    # (d, d)
    nac0: torch.Tensor     # (d,)
    mass: torch.Tensor     # (d,)
    origin: float = 0.0

    @staticmethod
    def from_fchk(freq_fchk, nac_fchk, device):
        pos0, energy0, grad0, hess0 = freq_fchk.harmonic_approximation()
        nac0 = nac_fchk.nonadiabatic_coupling()
        mass = freq_fchk.masses()
        logger.info(f"atomic masses (multiples of electron mass): {mass}")
        return MolecularHarmonicPotential.from_arrays(
            pos0=pos0, energy0=float(np.ravel(energy0)[0]), grad0=grad0,
            hess0=hess0, nac0=nac0, mass=mass, origin=0.0, device=device)

    @staticmethod
    def from_arrays(pos0, energy0, grad0, hess0, nac0, mass, origin, device):
        t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                   device=device)
        return MolecularHarmonicPotential(
            pos0=t(pos0), energy0=float(energy0), grad0=t(grad0),
            hess0=t(hess0), nac0=t(nac0), mass=t(mass), origin=float(origin))

    @property
    def device(self):
        return self.pos0.device

    def masses(self) -> torch.Tensor:
        return self.mass

    def total_energy(self) -> float:
        """Energy at the minimum (after `minimize`), Hartree."""
        return self.origin

    def local_expansion(self, q):
        """(V, grad V, Hessian operator) at the positions q (n, d)."""
        dr = q - self.pos0[None, :]                          # (n, d)
        hdr = dr @ self.hess0.T                              # (n, d)
        expans = dr @ self.grad0 + 0.5 * torch.sum(dr * hdr, dim=1)
        v = (self.energy0 - self.origin) + expans
        grad = self.grad0[None, :] + hdr
        return v, grad, ConstHessian(mat=self.hess0)

    def derivative_coupling_1st(self, q):
        return self.nac0[None, :].expand(q.shape)

    def derivative_coupling_2nd(self, q):
        return torch.zeros_like(q)


def minimize(potential, r_guess, maxiter=200, rtol=1.0e-5, gtol=1.0e-7):
    """Locate the PES minimum near `r_guess` and fix the energy origin there.

    Newton steps dr = -hess^{+} grad (pseudo-inverse: molecular Hessians
    carry ~6 near-zero translational/rotational modes) with a
    steepest-descent fallback and Armijo backtracking. The loop runs on the
    host at f64: it is a handful of iterations on a single geometry.

    Returns a new potential with ``origin`` set to the minimum energy.
    """
    pot0 = dataclasses.replace(potential, origin=0.0)
    device = potential.device

    def expansion(r):
        v, g, h = pot0.local_expansion(
            torch.as_tensor(r, dtype=torch.float64, device=device)[None, :])
        return (float(v[0]), g[0].cpu().numpy(), h.mat.cpu().numpy())

    def energy_only(r):
        return expansion(r)[0]

    r = np.asarray(r_guess, dtype=np.float64)
    for i in range(maxiter):
        energy, grad_h, hess_h = expansion(r)
        evals, evecs = np.linalg.eigh(0.5 * (hess_h + hess_h.T))
        keep = np.abs(evals) > 1.0e-8 * np.abs(evals).max()
        dr = -(evecs[:, keep] / evals[keep]) @ (evecs[:, keep].T @ grad_h)
        delta_energy = float(np.sum(grad_h * dr))
        if delta_energy > 0.0:
            # not a descent direction -> steepest descent
            dr = -grad_h
            delta_energy = float(np.sum(grad_h * dr))

        grad_norm = float(np.linalg.norm(grad_h))
        disp_norm = float(np.linalg.norm(dr))
        logger.info(
            f"  iteration= {i:5}  energy= {energy:f} Hartree  "
            f"|gradient|= {grad_norm:e} (threshold= {gtol})  "
            f"|geometry change|= {disp_norm:e} (threshold= {rtol})"
        )
        if grad_norm < gtol or disp_norm < rtol:
            logger.info("  converged")
            break

        # Armijo backtracking line search (Nocedal & Wright, Algorithm 3.1)
        rho, c_armijo, lmax = 0.3, 1.0e-4, 100
        a = 1.0
        for _ in range(lmax):
            r_interp = r + a * dr
            if energy_only(r_interp) <= energy + c_armijo * a * delta_energy:
                break
            a *= rho
        else:
            raise RuntimeError(
                "Linesearch failed! Could not find a step length that "
                "satisfies the sufficient decrease condition."
            )
        r = r_interp
    else:
        raise RuntimeError(f"Could not find minimum within {maxiter} iterations.")

    emin = energy_only(r)
    logger.info(f"shift origin of energy axis to minimum energy = {emin} Hartree")
    return dataclasses.replace(potential, origin=emin)
