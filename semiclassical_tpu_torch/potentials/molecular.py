# coding: utf-8
"""Molecular potential energy surfaces — the port of
`semiclassical_tpu.potentials.molecular`.

* `MolecularHarmonicPotential` is the second-order Taylor PES built from a
  Gaussian 16 frequency checkpoint, with a constant Hessian and a constant
  NAC vector (Condon approximation).
* `MolecularGDMLPotential` is the sGDML machine-learned ground-state PES
  (`semiclassical_tpu_torch.gdml`) with a constant NAC vector, its
  reduced-precision Hessian (`hess_dtype`) and its reduced-cost Hessian
  modes (`hessian_eval`, `taylor_every`; see `propagation.eom`).
* `minimize` locates the PES minimum by Newton steps with Armijo
  backtracking and returns a potential whose energy origin sits there;
  that origin sets the phase of C(t) and the adiabatic gap, so the loop
  runs at f64 on the host.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.gdml import GDMLParams, gdml_forward
from semiclassical_tpu_torch.potentials.base import ConstHessian, DenseHessian

logger = logging.getLogger(__name__)

__all__ = ["MolecularHarmonicPotential", "MolecularGDMLPotential",
           "minimize"]


@dataclass(frozen=True)
class MolecularHarmonicPotential:
    """Harmonic expansion around a reference geometry (usually the minimum):

        V(r') = V0 + grad0^T (r' - r0) + 1/2 (r' - r0)^T hess0 (r' - r0)

    All fields are float64 tensors on one device; `origin` is the energy
    origin set by `minimize` (a Python float). `contract_dtype` (None or
    torch.float32) runs the PES contractions at that type while the
    displacement q - r0 keeps the trajectory precision and the energy
    offset stays float64: the reduced-precision modes' form of this PES.
    """

    pos0: torch.Tensor     # (d,)
    energy0: float
    grad0: torch.Tensor    # (d,)
    hess0: torch.Tensor    # (d, d)
    nac0: torch.Tensor     # (d,)
    mass: torch.Tensor     # (d,)
    origin: float = 0.0
    contract_dtype: torch.dtype | None = None

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
    def from_arrays(pos0, energy0, grad0, hess0, nac0, mass, origin, device,
                    contract_dtype=None):
        t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                   device=device)
        return MolecularHarmonicPotential(
            pos0=t(pos0), energy0=float(energy0), grad0=t(grad0),
            hess0=t(hess0), nac0=t(nac0), mass=t(mass), origin=float(origin),
            contract_dtype=contract_dtype)

    @property
    def device(self):
        return self.pos0.device

    def masses(self) -> torch.Tensor:
        return self.mass

    def total_energy(self) -> float:
        """Energy at the minimum (after `minimize`), Hartree."""
        return self.origin

    def local_expansion(self, q):
        """(V, grad V, Hessian operator) at the positions q (n, d): the
        displacement at q's dtype, the contractions at `contract_dtype`
        (default q's), grad V at q's dtype and V at float64."""
        dr = q - self.pos0.to(q.dtype)[None, :]              # (n, d)
        t = self.contract_dtype or dr.dtype
        drt = dr.to(t)
        hess, grad0 = self._at(t)
        hdr = drt @ hess.T                                   # (n, d)
        expans = drt @ grad0 + 0.5 * torch.sum(drt * hdr, dim=1)
        v = (self.energy0 - self.origin) + expans.to(q.dtype).to(
            torch.float64)
        # hdr (at t, no wider than q's dtype) is widened inside the add
        grad = self._at(q.dtype)[1][None, :] + hdr
        return v, grad, ConstHessian(mat=hess)

    def _at(self, dtype):
        """(hess0, grad0) at `dtype`, cast once per potential object (kept
        in the instance's own dict: the dataclass is frozen)."""
        casts = self.__dict__.setdefault("_casts", {})
        if dtype not in casts:
            casts[dtype] = (self.hess0.to(dtype), self.grad0.to(dtype))
        return casts[dtype]

    def derivative_coupling_1st(self, q):
        return self.nac0[None, :].expand(q.shape)

    def derivative_coupling_2nd(self, q):
        return torch.zeros_like(q)


@dataclass(frozen=True)
class MolecularGDMLPotential:
    """sGDML machine-learned ground-state PES with a constant NAC vector.

    `hess_dtype` (None or torch.float32) is the precision of the Hessian
    contractions; energies and gradients stay f64 (the KRR sums cancel
    1e5-1e7x). `hessian_eval` selects how often the integrator samples
    the PES: "stage" (every RK4 stage), "step" (gradients at every stage,
    the Hessian once per step) or "taylor" (one order-2 evaluation per
    step, or per window of `taylor_every` steps). `origin` is the energy
    origin set by `minimize`.
    """

    gdml: GDMLParams
    nac0: torch.Tensor    # (d,)
    mass: torch.Tensor    # (d,)
    origin: float = 0.0
    hess_dtype: torch.dtype | None = None
    hessian_eval: str = "stage"
    taylor_every: int = 1

    @staticmethod
    def create(model_pot, nac_fchk, device, hess_dtype=None,
               hessian_eval="stage", taylor_every=1, eg_mode="f64"):
        """From a trained sGDML model mapping and the fchk that carries the
        NAC vector and the masses. `hess_dtype` is None, a torch dtype or
        its name ("float32")."""
        gdml = GDMLParams.from_npz(model_pot, device, eg_mode=eg_mode)
        nac0 = nac_fchk.nonadiabatic_coupling()
        model_z = np.asarray(dict(model_pot)["z"])
        if not np.array_equal(model_z, nac_fchk.atomic_numbers()):
            raise ValueError("GDML model and NAC checkpoint should describe "
                             "the same molecule")
        mass = nac_fchk.masses()
        logger.info(f"atomic masses (multiples of electron mass): {mass}")
        if hessian_eval not in ("stage", "step", "taylor"):
            raise ValueError(f"unknown hessian_eval {hessian_eval!r} "
                             "(expected 'stage', 'step' or 'taylor')")
        taylor_every = int(taylor_every)
        if taylor_every < 1:
            raise ValueError("taylor_every must be >= 1")
        if taylor_every > 1 and hessian_eval != "taylor":
            raise ValueError(
                "taylor_every > 1 requires hessian_eval='taylor'")
        if isinstance(hess_dtype, str):
            hess_dtype = getattr(torch, hess_dtype)
        if hess_dtype == torch.float64:
            hess_dtype = None
        t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                   device=device)
        return MolecularGDMLPotential(
            gdml=gdml, nac0=t(nac0), mass=t(mass), hess_dtype=hess_dtype,
            hessian_eval=hessian_eval, taylor_every=taylor_every)

    @property
    def device(self):
        return self.mass.device

    def masses(self) -> torch.Tensor:
        return self.mass

    def total_energy(self) -> float:
        return self.origin

    def local_expansion(self, q):
        v, grad, hess = gdml_forward(self.gdml, q, order=2,
                                     hess_dtype=self.hess_dtype)
        return v - self.origin, grad, DenseHessian(mat=hess)

    def value_grad(self, q):
        """Energy + gradient only (order 1): the cheap stage evaluation of
        hessian_eval "step"."""
        v, grad = gdml_forward(self.gdml, q, order=1)
        return v - self.origin, grad

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
        d = g.shape[1]
        # the Hessian at its own dtype, (1, d, d) or (d, d) alike
        return (float(v[0]), g[0].cpu().numpy(),
                h.dense().cpu().numpy().reshape(d, d))

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
