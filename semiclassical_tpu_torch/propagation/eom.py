# coding: utf-8
"""Newton's equations of motion for trajectories + monodromy matrices, and
the fixed-step RK4 integrator (the port of `semiclassical_tpu`'s
`eom.state_derivative`, `eom.rk4_step` and the `taylor_every` windows).

The trajectory block (q, p, S) takes one PES evaluation per RK4 stage, as
the JAX package and the original torch code do, unless the potential opts
into a reduced-cost mode through its `hessian_eval` attribute (sGDML):

* "stage" (default): the full local expansion at every stage;
* "step": gradients at all four stages, the Hessian once per step at the
  midpoint stage, frozen across the monodromy update (midpoint-Magnus);
  the trajectories are those of "stage" bit for bit;
* "taylor": ONE order-2 evaluation per step at the free-flight midpoint
  q + dt/2 p/m; the four stage forces come from the local quadratic
  expansion there, and the monodromy freezes its Hessian. The quadratic
  corrections run at the Hessian's dtype, the anchors at theirs.

The monodromy step has these forms:

* constant Hessian (harmonic molecular PES): one RK4 step is exactly the
  degree-4 truncated exponential

      T = I + h L + h^2/2 L^2 + h^3/6 L^3 + h^4/24 L^4,
      L = [[0, diag(1/m)], [-H, 0]]   (2d, 2d)

  applied to the stacked blocks Z; T depends only on the potential and dt,
  so the propagator builds it once per propagation (`const_step_map`);
* a frozen per-trajectory dense Hessian ("step", "taylor"): the same
  polynomial by Horner's rule on the column-stacked blocks [Mqq | Mqp],
  [Mpq | Mpp], four batched H-products per step; inside a `taylor_every`
  window the (n, 2d, 2d) map itself is built once per window (`Tmono`) and
  each step is one batched product;
* four different dense stage Hessians ("stage"): the 4-stage chain, on the
  column-stacked blocks;
* diagonal Hessians at every stage (separable PES, the diagonal monodromy
  representation): the step of mode i is the per-(trajectory, mode) 2x2
  linear map obtained by running the stage recurrence on the (1, 0) and
  (0, 1) seeds, applied to the (n, d) planes.

`make_taylor_window` gives the `taylor_every` window: one order-2 PES
evaluation per window of `every` steps, at the free-flight window midpoint,
with every step inside the window run by the per-step taylor machinery on
the frozen quadratic (`LocalQuadratic`). The window restarts at the head of
every scan segment, as in the JAX package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.potentials.base import (ConstHessian,
                                                     DenseHessian,
                                                     DiagHessian)
from semiclassical_tpu_torch.propagation.state import TrajState

__all__ = ["state_derivative", "const_step_map", "rk4_step",
           "LocalQuadratic", "make_taylor_window"]

HESSIAN_EVAL_MODES = ("stage", "step", "taylor")


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


def _comp_accumulate(x, c, inc):
    """One Neumaier-compensated accumulation step of the comp32 mode:
    (x', c') with x' + c' = x + c + inc to about twice the precision of
    x, c and inc, with arithmetic at their (float32) type only.

    `c` is the running residual (true value = x + c). The residual folds
    into the increment, then a branch-free exact two-sum (Knuth) splits
    x + y into the rounded sum and its exact error. Eager PyTorch rounds
    each operation as written, so the cancellation is not reassociated
    away."""
    y = inc + c
    t = x + y
    yv = t - x            # the part of y that made it into t
    xv = t - yv           # the part of x that made it into t
    r = (x - xv) + (y - yv)
    return t, r


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _at(x, dtype):
    """The Python float `x` rounded to the real torch `dtype`, as a numpy
    scalar of that type: arithmetic on it rounds at that type, as the JAX
    package's step constants do (a float64 step keeps the Python
    float's values)."""
    return _NP_DTYPE[dtype](x)


def const_step_map(hess: ConstHessian, masses: torch.Tensor, dt: float,
                   dtype=None):
    """The (2d, 2d) RK4 step map T of the monodromy for a constant Hessian,
    by Horner's rule on L = [[0, diag(1/m)], [-H, 0]], at `dtype` (the
    monodromy's; default the Hessian's): the Hessian, 1/m and the step
    are rounded to it first, and the products run at it."""
    dtype = hess.mat.dtype if dtype is None else dtype
    H = hess.mat.to(dtype)
    d = H.shape[0]
    dts = _at(dt, dtype)
    L = torch.zeros(2 * d, 2 * d, dtype=dtype, device=H.device)
    L[:d, d:] = torch.diag((1.0 / masses).to(dtype))
    L[d:, :d] = -H
    eye2 = torch.eye(2 * d, dtype=dtype, device=H.device)
    T = eye2 + float(dts / 4) * L
    T = eye2 + float(dts / 3) * (L @ T)
    T = eye2 + float(dts / 2) * (L @ T)
    return eye2 + float(dts) * (L @ T)


def _hessian_dtype(H):
    return H.diag.dtype if isinstance(H, DiagHessian) else H.mat.dtype


def rk4_step(state: TrajState, potential, dt: float, step_map=None):
    """One classic 4th-order Runge-Kutta step.

    Returns (new_state, mean_energy_at_step_start) — the energy is the k1
    stage's <T + V> (the exact state at time t), whose step-to-step drift
    the conservation guard monitors; it stays a 0-d tensor on the device.
    `step_map` is the precomputed `const_step_map` of a constant-Hessian
    potential and dt (dense representation only); it is built here when
    not given. The potential's `hessian_eval` (default "stage") selects
    the reduced-cost modes described in the module docstring; a potential
    with a `Tmono` (a `LocalQuadratic` window) steps the monodromy with it.

    Precision: the stage arithmetic runs at the trajectory dtype (q's),
    with dt and 1/m rounded to it once, and the PES outputs cast to it; the
    monodromy runs at Z's dtype, with dt, 1/m and the stage Hessians
    rounded to it. A compensated (comp32) state folds the q and p
    increments in through `_comp_accumulate`; S keeps its own dtype.
    """
    inv_m = 1.0 / potential.masses()                      # (d,)
    q, p, S = state.q, state.p, state.S
    tdt = _at(dt, q.dtype)
    half = float(_NP_DTYPE[q.dtype](0.5) * tdt)
    full = float(tdt)
    inv_m_t = inv_m.to(q.dtype)
    hessian_eval = getattr(potential, "hessian_eval", "stage")
    if hessian_eval not in HESSIAN_EVAL_MODES:
        raise ValueError(f"unknown hessian_eval {hessian_eval!r} "
                         "(expected 'stage', 'step' or 'taylor')")
    frozen = hessian_eval != "stage"
    value_grad = getattr(potential, "value_grad", None)
    if value_grad is None:
        def value_grad(qs):
            vpot, grad, _ = potential.local_expansion(qs)
            return vpot, grad

    H_mid = None
    if hessian_eval == "taylor":
        # one order-2 evaluation at the free-flight midpoint; the stage
        # forces come from the quadratic expansion there, its corrections
        # (small step-scale quantities) at the Hessian's precision
        q_mid = q + half * (p * inv_m_t[None, :])
        v_mid, g_mid, H_mid = potential.local_expansion(q_mid)
        cdt = _hessian_dtype(H_mid)
        g_mid_c = g_mid.to(cdt)

        def value_grad(qs):
            delta = (qs - q_mid).to(cdt)
            hd = H_mid.matvec(delta)
            v = v_mid + torch.sum((g_mid_c + 0.5 * hd) * delta,
                                  dim=1).to(v_mid.dtype)
            return v, g_mid + hd.to(g_mid.dtype)

    def pack(ps, vpot, grad):
        tkin = 0.5 * torch.sum(ps**2 * inv_m_t[None, :], dim=1)
        vpot = vpot.to(tkin.dtype)
        return ((ps * inv_m_t[None, :], -grad.to(p.dtype),
                 (tkin - vpot).to(S.dtype)), tkin + vpot)

    def stage(qs, ps):
        vpot, grad, hess = potential.local_expansion(qs)
        return (*pack(ps, vpot, grad), hess)

    def stage_nohess(qs, ps):
        return (*pack(ps, *value_grad(qs)), None)

    if frozen:
        k1, e1, _ = stage_nohess(q, p)
        if H_mid is None:
            # "step": the Hessian at the midpoint stage
            k2, _, H_mid = stage(q + half * k1[0], p + half * k1[1])
        else:
            k2, _, _ = stage_nohess(q + half * k1[0], p + half * k1[1])
        k3, _, _ = stage_nohess(q + half * k2[0], p + half * k2[1])
        k4, _, _ = stage_nohess(q + full * k3[0], p + full * k3[1])
        H1 = H2 = H3 = H4 = H_mid
    else:
        k1, e1, H1 = stage(q, p)
        k2, _, H2 = stage(q + half * k1[0], p + half * k1[1])
        k3, _, H3 = stage(q + half * k2[0], p + half * k2[1])
        k4, _, H4 = stage(q + full * k3[0], p + full * k3[1])
    sixth = float(tdt / _NP_DTYPE[q.dtype](6.0))
    inc_q = sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
    inc_p = sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
    if state.compensated:
        new_q, new_qc = _comp_accumulate(q, state.qc, inc_q)
        new_p, new_pc = _comp_accumulate(p, state.pc, inc_p)
    else:
        new_q, new_p = q + inc_q, p + inc_p
        new_qc = new_pc = None
    new_S = S + sixth * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])
    hs = (H1, H2, H3, H4)

    mdt = state.Z.dtype
    if state.diag_monodromy:
        if not all(isinstance(H, DiagHessian) for H in hs):
            raise TypeError(
                "diagonal-monodromy state requires a separable potential "
                "(DiagHessian local expansions)")
        new_Z = _diag_step(state.Z, inv_m.to(mdt),
                           tuple(H.diag.to(mdt) for H in hs), dt)
    elif all(isinstance(H, ConstHessian) for H in hs):
        if step_map is None:
            step_map = const_step_map(H1, potential.masses(), dt, mdt)
        new_Z = torch.matmul(step_map, state.Z)
    elif all(isinstance(H, DenseHessian) for H in hs):
        Tw = getattr(potential, "Tmono", None)
        if frozen and Tw is not None:
            # taylor_every window: the degree-4 map of the window Hessian
            new_Z = torch.matmul(Tw.to(mdt), state.Z)
        elif frozen:
            new_Z = _frozen_step(state, inv_m.to(mdt), H1, dt)
        else:
            new_Z = _chain_step(state, inv_m.to(mdt), hs, dt)
    else:
        raise TypeError(
            f"rk4_step steps the dense monodromy under ConstHessian or "
            f"DenseHessian expansions; got "
            f"{', '.join(sorted({type(H).__name__ for H in hs}))}")
    return (TrajState(q=new_q, p=new_p, Z=new_Z, S=new_S, qc=new_qc,
                      pc=new_pc), torch.mean(e1))


def _horner_steps(dt, dtype):
    """The Horner coefficients dt/4, dt/3, dt/2, dt at `dtype`."""
    dts = _at(dt, dtype)
    return tuple(float(dts / _NP_DTYPE[dtype](k)) for k in (4, 3, 2, 1))


def _frozen_step(state, inv_m, H, dt):
    """The degree-4 truncated exponential of L = [[0, 1/m], [-H_n, 0]]
    (H frozen over the step) applied to the stacked blocks Z, by Horner on
    the column-stacked [Mqq | Mqp] / [Mpq | Mpp]: one batched (n, d, d) @
    (n, d, 2d) product per Horner stage."""
    d = state.dim
    im = inv_m[None, :, None]
    Mq, Mp = state.Z[:, :d, :], state.Z[:, d:, :]
    Yq, Yp = Mq, Mp
    for c in _horner_steps(dt, state.Z.dtype):
        LYq = Yp * im
        LYp = -H.matmul(Yq)
        Yq = Mq + c * LYq
        Yp = Mp + c * LYp
    return torch.cat([Yq, Yp], dim=1)


def _rk4_weights(dt, dtype):
    """(dt/6, dt/3, dt/2, dt) at `dtype`."""
    dts = _at(dt, dtype)
    f = _NP_DTYPE[dtype]
    return (float(dts / f(6.0)), float(dts / f(3.0)), float(dts / f(2.0)),
            float(dts))


def _chain_step(state, inv_m, hs, dt):
    """The 4-stage RK4 chain of dMa/dt = Mb/m, dMb/dt = -H(t) Ma under four
    stage Hessians, on the column-stacked pairs (Ma, Mb) = ([Mqq | Mqp],
    [Mpq | Mpp]) (the two pairs are independent columns of one system)."""
    d = state.dim
    im = inv_m[None, :, None]
    h6, h3, h2, dt = _rk4_weights(dt, state.Z.dtype)
    Ma, Mb = state.Z[:, :d, :], state.Z[:, d:, :]
    ka = Mb * im
    kb = -hs[0].matmul(Ma)
    acc_a = Ma + h6 * ka
    acc_b = Mb + h6 * kb
    sa = Ma + h2 * ka
    sb = Mb + h2 * kb
    ka = sb * im
    kb = -hs[1].matmul(sa)
    acc_a = acc_a + h3 * ka
    acc_b = acc_b + h3 * kb
    sa = Ma + h2 * ka
    sb = Mb + h2 * kb
    ka = sb * im
    kb = -hs[2].matmul(sa)
    acc_a = acc_a + h3 * ka
    acc_b = acc_b + h3 * kb
    sa = Ma + dt * ka
    sb = Mb + dt * kb
    ka = sb * im
    kb = -hs[3].matmul(sa)
    return torch.cat([acc_a + h6 * ka, acc_b + h6 * kb], dim=1)


@functools.lru_cache(maxsize=None)
def _seeds(dtype, device):
    """The seeds (1, 0) and (0, 1) of `_diag_step`, each (2, 1, 1), made
    once per dtype and device (by the first step, which the time loop
    runs eagerly): a step makes no tensor from host values, so a captured
    step holds no host-to-device copy."""
    eye = torch.eye(2, dtype=dtype, device=device)
    return eye[:, 0].view(2, 1, 1), eye[:, 1].view(2, 1, 1)


def _diag_step(Z, inv_m, hs, dt):
    """The RK4 step of the diagonal monodromy planes Z (4, n, d) under the
    stage Hessian diagonals `hs` (four (n, d) tensors): the per-mode 2x2
    row map of the stage recurrence, run on the seeds (1, 0) and (0, 1) at
    once (a leading axis of 2), then applied to the (q-row, p-row) pairs
    (Mqq, Mpq) and (Mqp, Mpp). Everything runs at Z's dtype."""
    u = inv_m[None, None, :]
    h6, h3, h2, dt = _rk4_weights(dt, Z.dtype)
    a, b = _seeds(Z.dtype, Z.device)
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


# ---------------------------------------------------------------------------
# k-step re-expansion windows (taylor_every)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LocalQuadratic:
    """Frozen local quadratic expansion of an expensive PES, the
    `taylor_every` window surrogate:

        V(q) = v0 + g0 . (q - q_mid) + 1/2 (q - q_mid)^T H (q - q_mid).

    Acts as the potential inside `rk4_step` with hessian_eval "taylor":
    re-expanding a quadratic about any point is exact, so the per-step
    taylor machinery reproduces this window's forces and freezes this
    window's H for the monodromy. v0 and g0 keep the parent's dtype (they
    anchor the action phase); H rides at the parent's Hessian dtype and
    only scales small displacements. `Tmono` (n, 2d, 2d) is the window's
    monodromy step map (dense representation), None for a diagonal H.
    """

    q_mid: torch.Tensor   # (n, d)
    v0: torch.Tensor      # (n,)
    g0: torch.Tensor      # (n, d)
    H: torch.Tensor       # (n, d, d) dense, or (n, d) diagonal (separable)
    mass: torch.Tensor    # (d,)
    nac0: torch.Tensor    # (d,)
    Tmono: torch.Tensor | None = None
    hessian_eval: str = "taylor"

    def masses(self):
        return self.mass

    def _hessian_op(self):
        return (DiagHessian(diag=self.H) if self.H.dim() == 2
                else DenseHessian(mat=self.H))

    def local_expansion(self, q):
        delta = q - self.q_mid                                  # (n, d)
        hop = self._hessian_op()
        hd = hop.matvec(delta.to(self.H.dtype))
        # the linear anchor term at full precision, the quadratic
        # correction at the Hessian's
        v = (self.v0 + torch.sum(self.g0 * delta, dim=1)
             + 0.5 * torch.sum(hd * delta.to(hd.dtype),
                               dim=1).to(self.v0.dtype))
        return v, self.g0 + hd.to(self.g0.dtype), hop

    def derivative_coupling_1st(self, q):
        return self.nac0[None, :].expand(q.shape)

    def derivative_coupling_2nd(self, q):
        return torch.zeros_like(q)


def _window_mono_map(Hw, inv_m, dt, mdt):
    """The degree-4 truncated exponential T (n, 2d, 2d) of the window
    Hessian Hw (n, d, d) at the monodromy dtype `mdt`: Horner on the
    identity rows, once per window."""
    n, d = Hw.shape[0], Hw.shape[1]
    im = inv_m.to(mdt)[None, :, None]
    eye = torch.eye(2 * d, dtype=mdt, device=Hw.device)
    eyeq = eye[:d].expand(n, d, 2 * d)
    eyep = eye[d:].expand(n, d, 2 * d)
    Hm = Hw.to(mdt)
    Yq, Yp = eyeq, eyep
    for c in _horner_steps(dt, mdt):
        LYq = Yp * im
        LYp = -torch.matmul(Hm, Yq)
        Yq = eyeq + c * LYq
        Yp = eyep + c * LYp
    return torch.cat([Yq, Yp], dim=1)


def make_taylor_window(potential, dt, every):
    """(carry0, step) of the `taylor_every` window for a hessian_eval
    "taylor" potential.

    `carry0(state)` expands the PES at the free-flight window midpoint
    q + (every dt / 2) p/m and returns the carry (LocalQuadratic, 0);
    `step(state, carry)` re-expands at the current state when a window is
    full, runs `rk4_step` on the window's quadratic and returns
    (new_state, mean_energy, carry). The caller starts each scan segment
    with `carry0`, so the window phase restarts there.
    """
    inv_m = 1.0 / potential.masses()

    def expand(state):
        q, p = state.q, state.p
        if state.compensated:
            q, p = q + state.qc, p + state.pc
        half_window = float(_NP_DTYPE[q.dtype](0.5 * every) * _at(dt, q.dtype))
        qp = q + half_window * (p * inv_m.to(q.dtype)[None, :])
        v0, g0, H = potential.local_expansion(qp)
        if isinstance(H, DiagHessian):
            Hw, Tw = H.diag, None
        else:
            Hw = H.dense().expand(q.shape[0], q.shape[1], q.shape[1])
            Tw = (None if state.diag_monodromy
                  else _window_mono_map(Hw, inv_m, dt, state.Z.dtype))
        return LocalQuadratic(
            q_mid=qp, v0=v0, g0=g0, H=Hw, Tmono=Tw, mass=potential.masses(),
            nac0=potential.derivative_coupling_1st(qp[:1])[0])

    def carry0(state):
        return expand(state), 0

    def step(state, carry):
        quad, cnt = carry
        if cnt % every == 0 and cnt > 0:
            quad = expand(state)
        new_state, energy = rk4_step(state, quad, dt)
        return new_state, energy, (quad, cnt + 1)

    return carry0, step
