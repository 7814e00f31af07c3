# coding: utf-8
"""Exact propagation map for a constant-Hessian (harmonic) molecular PES,
the port of `semiclassical_tpu.propagation.exact_harmonic`.

The molecular harmonic potential is a global quadratic

    V(q) = E0 + g0.(q - r0) + 1/2 (q - r0)^T H (q - r0),

so Hamilton's equations for z = (dq, p), dq = q - r0, are linear-affine,
dz/dt = L z + c with L = [[0, M^-1], [-H, 0]] and c = (0, -g0), and one
step of any size is the exact affine map

    z(t + dt) = T z(t) + w,     [[T, w], [0, 1]] = expm(dt [[L, c], [0, 0]]).

The monodromy obeys dM/dt = L M, so M(t + dt) = T M(t). The action
increment of the step is the integral of the quadratic form
dS/dt = 1/2 zeta^T Qt zeta along the flow, zeta = (z, 1), which Van Loan's
block identity gives in closed form: DeltaS = 1/2 zeta^T W zeta.

T, w and W are built once on the host in float64 (`scipy.linalg.expm`);
the step is the increment z' = z + (T - I) z + w (one (n, 2d) @ (2d, 2d)
product), the action 1/2 z.Wzz z + wz.z + 1/2 w11, and the monodromy one
product T @ Z on the stacked blocks Z (n, 2d, 2d). The increment, the
action's quadratic form and the monodromy product run at the monodromy's
dtype (float32 under the "mixed" mode, as in the JAX package: the entries
of T - I are O(omega dt), so the rounding costs eps |omega dt z| a step),
the action's linear and constant anchors at float64. On float32
trajectories the step reads the comp32 residuals and folds its increments
back through the compensated accumulate (`harmonic_step`). At float64
there is no time-discretization error at any dt and no drift of the
energy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.propagation.eom import _comp_accumulate
from semiclassical_tpu_torch.propagation.state import TrajState

__all__ = ["HarmonicMap", "build_harmonic_map", "harmonic_step",
           "supports_exact_harmonic"]


@dataclass(frozen=True)
class HarmonicMap:
    """The constants of the exact step of a quadratic PES: dT, w, T and
    Wzz at the monodromy's dtype, wz, w11 and pos0 at float64."""

    dT: torch.Tensor     # (2d, 2d) expm(L dt) - I
    w: torch.Tensor      # (2d,) affine drift
    T: torch.Tensor      # (2d, 2d) expm(L dt), the monodromy step
    Wzz: torch.Tensor    # (2d, 2d) action quadratic form
    wz: torch.Tensor     # (2d,) action linear form (float64)
    w11: float           # action constant
    pos0: torch.Tensor   # (d,) expansion center


def supports_exact_harmonic(potential) -> bool:
    """True when the potential is a global quadratic the map represents
    (duck-typed on the `MolecularHarmonicPotential` fields)."""
    return all(hasattr(potential, f)
               for f in ("pos0", "energy0", "grad0", "hess0", "origin"))


def build_harmonic_map(potential, dt, state: TrajState) -> HarmonicMap:
    """The exact-step constants on the host in float64, moved to the
    potential's device (the monodromy-side ones at `state`'s monodromy
    dtype). `state` must be in the dense representation."""
    import scipy.linalg as sla

    if not supports_exact_harmonic(potential):
        raise ValueError(
            "integrator='exact' on a molecular path requires a "
            "constant-Hessian (harmonic) potential")
    if state.diag_monodromy:
        raise ValueError("exact harmonic map expects dense monodromy blocks")

    host = lambda x: x.detach().cpu().numpy().astype(np.float64)
    H = host(potential.hess0)
    g0 = host(potential.grad0)
    e0c = float(potential.energy0) - float(potential.origin)
    inv_m = 1.0 / host(potential.masses())
    d = H.shape[0]
    dt = float(dt)

    # affine flow: [[T, w], [0, 1]] = expm(dt [[L, c], [0, 0]])
    Lt = np.zeros((2 * d + 1, 2 * d + 1))
    Lt[:d, d:2 * d] = np.diag(inv_m)
    Lt[d:2 * d, :d] = -H
    Lt[d:2 * d, 2 * d] = -g0
    F2 = sla.expm(dt * Lt)
    T = F2[:2 * d, :2 * d]
    w = F2[:2 * d, 2 * d]

    # action form dS/dt = 1/2 zeta^T Qt zeta, zeta = (dq, p, 1)
    Qt = np.zeros((2 * d + 1, 2 * d + 1))
    Qt[:d, :d] = -H
    Qt[d:2 * d, d:2 * d] = np.diag(inv_m)
    Qt[:d, 2 * d] = -g0
    Qt[2 * d, :d] = -g0
    Qt[2 * d, 2 * d] = -2.0 * e0c

    # Van Loan: W = F2^T G = int_0^dt expm(s Lt)^T Qt expm(s Lt) ds, from
    # expm(dt [[-Lt^T, Qt], [0, Lt]]) = [[F1, G], [0, F2]]
    n = 2 * d + 1
    C = np.zeros((2 * n, 2 * n))
    C[:n, :n] = -Lt.T
    C[:n, n:] = Qt
    C[n:, n:] = Lt
    W = F2.T @ sla.expm(dt * C)[:n, n:]
    W = 0.5 * (W + W.T)

    mdt = state.Z.dtype
    t = lambda x, dtype=mdt: torch.tensor(np.ascontiguousarray(x),
                                          dtype=dtype,
                                          device=potential.hess0.device)
    return HarmonicMap(dT=t(T - np.eye(2 * d)), w=t(w), T=t(T),
                       Wzz=t(W[:2 * d, :2 * d]),
                       wz=t(W[:2 * d, 2 * d], torch.float64),
                       w11=float(W[2 * d, 2 * d]),
                       pos0=potential.pos0.to(torch.float64))


def harmonic_step(hmap: HarmonicMap, state: TrajState, potential):
    """One exact step. Returns (new_state, mean energy at the step start),
    the contract of `eom.rk4_step`.

    A comp32 state folds both residuals into the displacement and p before
    the map reads them (the map consumes p itself, so dropping pc would
    leave the compensation one-sided), and the increments fold back into
    (q, qc) and (p, pc) through `eom._comp_accumulate`; under the plain
    modes they are plain adds."""
    q, p = state.q, state.p
    d = state.dim
    dq = q - hmap.pos0.to(q.dtype)[None, :]
    pt = p
    if state.compensated:
        dq, pt = dq + state.qc, p + state.pc
    z = torch.cat([dq, pt], dim=1)                       # (n, 2d)

    # the energy guard reads <T + V> at the step start, at the folded values
    inv_m = (1.0 / potential.masses()).to(q.dtype)
    tkin = 0.5 * torch.sum(pt * pt * inv_m[None, :], dim=1)
    vpot = potential.local_expansion(
        q + state.qc if state.compensated else q)[0]
    mean_energy = torch.mean(tkin + vpot.to(tkin.dtype))

    zc = z.to(hmap.dT.dtype)
    inc = torch.addmm(hmap.w[None, :], zc, hmap.dT.T).to(q.dtype)  # (n, 2d)
    if state.compensated:
        new_q, new_qc = _comp_accumulate(q, state.qc, inc[:, :d])
        new_p, new_pc = _comp_accumulate(p, state.pc, inc[:, d:])
    else:
        new_q, new_p = q + inc[:, :d], p + inc[:, d:]
        new_qc = new_pc = None
    ds = (0.5 * torch.sum(zc * (zc @ hmap.Wzz.T), dim=1).to(torch.float64)
          + z.to(torch.float64) @ hmap.wz + 0.5 * hmap.w11)
    new_state = TrajState(q=new_q, p=new_p, Z=torch.matmul(hmap.T, state.Z),
                          S=state.S + ds.to(state.S.dtype), qc=new_qc,
                          pc=new_pc)
    return new_state, mean_energy
