# coding: utf-8
"""Newton's equations of motion for trajectories + monodromy matrices, and
the fixed-step RK4 integrator (the port of `semiclassical_tpu`'s
`eom.state_derivative` and the stage-mode `eom.rk4_step`).

The trajectory block (q, p, S) takes four PES evaluations per step, one per
RK4 stage, exactly as the JAX package and the original torch code do. The
monodromy step has two forms:

* constant Hessian (harmonic molecular PES): the 4-stage recurrence is a
  linear map with constant coefficients, so one RK4 step is exactly the
  degree-4 truncated exponential

      T = I + h L + h^2/2 L^2 + h^3/6 L^3 + h^4/24 L^4,
      L = [[0, diag(1/m)], [-H, 0]]   (2d, 2d)

  applied to the stacked blocks Z. T depends only on the potential and dt,
  so the propagator builds it once per propagation (`const_step_map`)
  rather than once per step;
* diagonal Hessians at every stage (separable PES, the diagonal monodromy
  representation): the step of mode i is the per-(trajectory, mode) 2x2
  linear map obtained by running the stage recurrence on the (1, 0) and
  (0, 1) seeds, applied to the (n, d) planes.

The frozen-Hessian and taylor-window branches of the JAX package are not
ported yet.
"""

from __future__ import annotations

import torch

from semiclassical_tpu_torch.potentials.base import ConstHessian, DiagHessian
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
    if state.diag_monodromy:
        if not isinstance(hess, DiagHessian):
            raise TypeError(
                "diagonal-monodromy state requires a separable potential "
                "(DiagHessian local expansions)")
        # planes [Mqq, Mqp, Mpq, Mpp]: d/dt [Mq*] = [Mp*] / m,
        # d/dt [Mp*] = -H [Mq*]
        dZ = torch.cat([state.Z[2:] * inv_m[None, None, :],
                        -(hess.diag[None] * state.Z[:2])], dim=0)
    else:
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
    dt (dense representation only); it is built here when not given.
    """
    inv_m = 1.0 / potential.masses()                      # (d,)
    q, p, S = state.q, state.p, state.S
    half = 0.5 * dt

    def stage(qs, ps):
        vpot, grad, hess = potential.local_expansion(qs)
        tkin = 0.5 * torch.sum(ps**2 * inv_m[None, :], dim=1)
        return (ps * inv_m[None, :], -grad, tkin - vpot), hess, tkin + vpot

    k1, H1, e1 = stage(q, p)
    k2, H2, _ = stage(q + half * k1[0], p + half * k1[1])
    k3, H3, _ = stage(q + half * k2[0], p + half * k2[1])
    k4, H4, _ = stage(q + dt * k3[0], p + dt * k3[1])
    sixth = dt / 6.0
    new_q = q + sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
    new_p = p + sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
    new_S = S + sixth * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])

    if state.diag_monodromy:
        if not all(isinstance(H, DiagHessian) for H in (H1, H2, H3, H4)):
            raise TypeError(
                "diagonal-monodromy state requires a separable potential "
                "(DiagHessian local expansions)")
        new_Z = _diag_step(state.Z, inv_m, (H1.diag, H2.diag, H3.diag,
                                            H4.diag), dt)
        return (TrajState(q=new_q, p=new_p, Z=new_Z, S=new_S),
                torch.mean(e1))
    if not isinstance(H1, ConstHessian):
        raise TypeError(
            f"rk4_step implements the dense monodromy step for a constant "
            f"Hessian (harmonic molecular PES) only; got {type(H1).__name__}")
    if step_map is None:
        step_map = const_step_map(H1, potential.masses(), dt)
    new_Z = torch.matmul(step_map, state.Z)
    return (TrajState(q=new_q, p=new_p, Z=new_Z, S=new_S),
            torch.mean(e1))


def _diag_step(Z, inv_m, hs, dt):
    """The RK4 step of the diagonal monodromy planes Z (4, n, d) under the
    stage Hessian diagonals `hs` (four (n, d) tensors): the per-mode 2x2
    row map of the stage recurrence, run on the seeds (1, 0) and (0, 1) at
    once (a leading axis of 2), then applied to the (q-row, p-row) pairs
    (Mqq, Mpq) and (Mqp, Mpp)."""
    u = inv_m[None, None, :]
    h6, h3, h2 = dt / 6.0, dt / 3.0, dt / 2.0
    a = torch.tensor([1.0, 0.0], dtype=Z.dtype, device=Z.device).view(2, 1, 1)
    b = torch.tensor([0.0, 1.0], dtype=Z.dtype, device=Z.device).view(2, 1, 1)
    ka = u * b
    kb = -hs[0] * a
    acc_a = a + h6 * ka
    acc_b = b + h6 * kb
    sa = a + h2 * ka
    sb = b + h2 * kb
    ka = u * sb
    kb = -hs[1] * sa
    acc_a = acc_a + h3 * ka
    acc_b = acc_b + h3 * kb
    sa = a + h2 * ka
    sb = b + h2 * kb
    ka = u * sb
    kb = -hs[2] * sa
    acc_a = acc_a + h3 * ka
    acc_b = acc_b + h3 * kb
    sa = a + dt * ka
    sb = b + dt * kb
    ka = u * sb
    kb = -hs[3] * sa
    raa, rab = acc_a + h6 * ka                  # each (n, d)
    rba, rbb = acc_b + h6 * kb
    top, bottom = Z[:2], Z[2:]                  # [Mqq, Mqp], [Mpq, Mpp]
    return torch.cat([raa * top + rab * bottom, rba * top + rbb * bottom])
