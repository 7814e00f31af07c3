# coding: utf-8
"""Newton's equations of motion for trajectories + monodromy matrices, and
the fixed-step RK4 integrator (the port of `semiclassical_tpu`'s
`eom.state_derivative` and the stage-mode `eom.rk4_step`).

The trajectory block (q, p, S) takes four PES evaluations per step, one per
RK4 stage, exactly as the JAX package and the original torch code do. The
monodromy step is implemented for a constant Hessian (harmonic molecular
PES): there the 4-stage recurrence is a linear map with constant
coefficients, so one RK4 step is exactly the degree-4 truncated exponential

    T = I + h L + h^2/2 L^2 + h^3/6 L^3 + h^4/24 L^4,
    L = [[0, diag(1/m)], [-H, 0]]   (2d, 2d)

applied to the stacked blocks Z. T depends only on the potential and dt,
so the propagator builds it once per propagation (`const_step_map`) rather
than once per step. The frozen-Hessian, taylor-window and diagonal
monodromy branches of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch

from semiclassical_tpu_torch.potentials.base import ConstHessian
from semiclassical_tpu_torch.propagation.state import TrajState

__all__ = ["state_derivative", "const_step_map", "rk4_step"]


def state_derivative(state: TrajState, potential):
    """dy/dt for the combined (q, p, M, S) system.

        dq/dt = p / m
        dp/dt = -grad V
        dMqq/dt = Mpq / m        dMqp/dt = Mpp / m
        dMpq/dt = -H Mqq         dMpp/dt = -H Mqp
        dS/dt = T - V

    Returns (dstate, mean_energy) where mean_energy = <T + V> over the batch
    (a 0-d tensor; nothing is brought to the host).
    """
    d = state.dim
    inv_m = 1.0 / potential.masses()                      # (d,)
    vpot, grad, hess = potential.local_expansion(state.q)
    tkin = 0.5 * torch.sum(state.p**2 * inv_m[None, :], dim=1)
    dZ = torch.cat([state.Z[:, d:, :] * inv_m[None, :, None],
                    -hess.matmul(state.Z[:, :d, :])], dim=1)
    dstate = TrajState(q=state.p * inv_m[None, :], p=-grad, Z=dZ,
                       S=tkin - vpot)
    return dstate, torch.mean(tkin + vpot)


def const_step_map(hess: ConstHessian, masses: torch.Tensor, dt: float):
    """The (2d, 2d) RK4 step map T of the monodromy for a constant Hessian,
    by Horner's rule on L = [[0, diag(1/m)], [-H, 0]]."""
    H = hess.mat
    d = H.shape[0]
    L = torch.zeros(2 * d, 2 * d, dtype=H.dtype, device=H.device)
    L[:d, d:] = torch.diag(1.0 / masses)
    L[d:, :d] = -H
    eye2 = torch.eye(2 * d, dtype=H.dtype, device=H.device)
    T = eye2 + (dt / 4.0) * L
    T = eye2 + (dt / 3.0) * (L @ T)
    T = eye2 + (dt / 2.0) * (L @ T)
    return eye2 + dt * (L @ T)


def rk4_step(state: TrajState, potential, dt: float, step_map=None):
    """One classic 4th-order Runge-Kutta step.

    Returns (new_state, mean_energy_at_step_start) — the energy is the k1
    stage's <T + V> (the exact state at time t), whose step-to-step drift
    the conservation guard monitors; it stays a 0-d tensor on the device.
    `step_map` is the precomputed `const_step_map` for this potential and
    dt; it is built here when not given.
    """
    inv_m = 1.0 / potential.masses()                      # (d,)
    q, p, S = state.q, state.p, state.S
    half = 0.5 * dt

    def stage(qs, ps):
        vpot, grad, hess = potential.local_expansion(qs)
        tkin = 0.5 * torch.sum(ps**2 * inv_m[None, :], dim=1)
        return (ps * inv_m[None, :], -grad, tkin - vpot), hess, tkin + vpot

    k1, H1, e1 = stage(q, p)
    k2, _, _ = stage(q + half * k1[0], p + half * k1[1])
    k3, _, _ = stage(q + half * k2[0], p + half * k2[1])
    k4, _, _ = stage(q + dt * k3[0], p + dt * k3[1])
    sixth = dt / 6.0
    new_q = q + sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
    new_p = p + sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
    new_S = S + sixth * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])

    if not isinstance(H1, ConstHessian):
        raise TypeError(
            f"rk4_step implements the monodromy step for a constant Hessian "
            f"(harmonic molecular PES) only; got {type(H1).__name__}")
    if step_map is None:
        step_map = const_step_map(H1, potential.masses(), dt)
    new_Z = torch.matmul(step_map, state.Z)
    return (TrajState(q=new_q, p=new_p, Z=new_Z, S=new_S),
            torch.mean(e1))
