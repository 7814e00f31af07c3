# coding: utf-8
"""Exact (closed-form) propagation map for separable Morse potentials, the
port of `semiclassical_tpu.propagation.exact_morse`.

The Morse oscillator is integrable: with E = p^2/2 + V(q) < D the orbit is

    e^{a q(th)} = (1 - s cos th) / (1 - eps),   th = th0 + wE t,
    p(th)       = (s wE / a) sin th / (1 - s cos th),

with eps = E/D, s = sqrt(eps), wE = w0 sqrt(1 - eps), w0 = a sqrt(2 D).
Positions, momenta, the monodromy M(t) = dZ(t)/dZ(0) and the action
S(t) = int (T - V) dt all have closed forms, so for a separable Morse PES
the RK4 stepper is replaced by a map with no time-discretization error:

* the setup (`build_morse_map`) runs once per batch in float64 (the comp32
  residuals folded into q and p first) and derives per-(trajectory, mode)
  constants from the current state;
* the only evolving quantity is the phase th (n, d), advanced by the
  constant wE dt (reduced mod 2 pi at build time) through a Neumaier
  two-sum and wrapped to [-pi, pi] (`morse_map_advance`), plus the time
  since the setup, kept as a float64 Python float;
* q, p, the four diagonal monodromy planes and S are evaluated fresh from
  the constants at every step (`morse_map_state`); the monodromy factorises
  as M(t) = Jhat(th) . shear(t) . Jhat(th0)^{-1} and is composed with the
  setup-time monodromy M0 when the state did not start at the identity
  (a resumed checkpoint, state surgery).

The map runs at the state's work dtype, q's: float64 under the "f64" and
"mixed" modes, float32 under "comp32" and "f32". The pack holds its
constants at that dtype, except the secular action terms (`A`, `S_base`)
and the bound rows' energy, which stay float64. The constants that grow
with time carry a float64 value as a (hi, lo) pair of the work dtype: the
shear rate (multiplied into the float64 time through a two-product), the
phase increment wE dt and 2 pi (folded into the phase's two-sum), and the
phase itself starts as the split of th0. At float64 every lo part is
exactly zero. Under comp32 the materialised state has zero residuals
(closed-form values carry no accumulated error) and a float64 S; under
f32 S is cast to float32.

Rows with a mode of eps > EPS_EXACT (unbound or near the separatrix) or a
non-finite value are routed to an RK4 side-channel: a sub-batch of exactly
those rows takes `eom.rk4_step` every step and is scattered into the
materialised state (`index_copy_` along the trajectory axis), so the
observables run once on the whole batch with its own constants and sign
trackers.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch.parallel.group import group_sum
from semiclassical_tpu_torch.propagation.eom import (_NP_DTYPE,
                                                     _comp_accumulate,
                                                     rk4_step)
from semiclassical_tpu_torch.propagation.state import TrajState

logger = logging.getLogger(__name__)

__all__ = ["EPS_EXACT", "RK4_FRACTION_MAX", "MorseMapPack", "MorseMapCarry",
           "supports_exact_morse", "build_morse_map", "morse_map_state",
           "morse_map_advance"]

# Trajectories whose largest per-mode eps = E/D exceeds this are routed to
# the RK4 side-channel: above it the orbit is unbound (eps >= 1) or close
# enough to the separatrix that the map's constants degrade (wE -> 0).
# Production Husimi ensembles do produce such rows (eps_max = 2.03 at
# 8192 x 60 modes on the AS model, measured with the JAX package).
EPS_EXACT = 0.9
# above this routed fraction the closed form is pointless for the ensemble
RK4_FRACTION_MAX = 0.25


def _split_hi_lo(x64, wdtype):
    """(hi, lo) at `wdtype` with hi + lo = the float64 `x64` to about twice
    wdtype's precision (lo is zero at float64)."""
    hi = x64.to(wdtype)
    return hi, (x64 - hi.to(torch.float64)).to(wdtype)


def _split_float(x, wdtype):
    """The Python float `x` as a (hi, lo) pair of Python floats, each
    exactly a value of `wdtype`."""
    hi = _NP_DTYPE[wdtype](x)
    return float(hi), float(_NP_DTYPE[wdtype](x - float(hi)))


@dataclass(frozen=True)
class MorseMapPack:
    """Per-batch constants of the exact Morse map at the work dtype, (n, d)
    unless noted; `A`, `S_base` and `e_bound_sum` are float64. Built once
    per (batch, potential, dt)."""

    s: torch.Tensor       # sqrt(eps)
    inv_a: torch.Tensor   # (d,) 1/a
    qoff: torch.Tensor    # -log1p(-eps)/a: q = log(den)/a + qoff
    pamp: torch.Tensor    # s wE / a
    cE: torch.Tensor      # wE / a
    c12a: torch.Tensor    # (d,) inv_a / 2
    c12b: torch.Tensor    # s/(1-eps) * inv_a
    c22a: torch.Tensor    # (wpE eps + wE/2) * inv_a
    c22b: torch.Tensor    # s wE inv_a / 2
    bco_hi: torch.Tensor  # eps wpE, the shear rate (hi part)
    bco_lo: torch.Tensor  # eps wpE (lo part)
    j011: torch.Tensor    # Jhat(th0)^{-1} entries
    j012: torch.Tensor
    j021: torch.Tensor
    j022: torch.Tensor
    beta: torch.Tensor    # s / (1 + sqrt(1-eps))
    pc1: torch.Tensor     # (d,) 2 D / w0 (action: coefficient of g)
    pc2: torch.Tensor     # -2 D (1-eps) s / wE (action: coefficient of sn/den)
    wdt_hi: torch.Tensor  # wE dt mod 2 pi (hi part)
    wdt_lo: torch.Tensor  # wE dt mod 2 pi (lo part)
    A: torch.Tensor       # (n,) secular dS/dt = sum_d E_d - 2 D (1 - rt)
    S_base: torch.Tensor  # (n,) S0 - P(th0) summed over modes
    e_bound_sum: torch.Tensor  # () energy summed over the closed-form rows
    m0: torch.Tensor | None = None   # (4, n, d) setup-time monodromy, or None
                                     # at the identity
    sub_idx: torch.Tensor | None = None  # (n_bad,) rows of the side-channel
    mono_dtype: torch.dtype = torch.float64  # the state's monodromy dtype
    compensated: bool = False  # comp32: zero residuals qc, pc, float64 S


@dataclass(frozen=True)
class MorseMapCarry:
    """The evolving part of the map: the phase and its two-sum residual
    (true phase th + thc, wrapped to [-pi, pi]), the time since the setup,
    and the side-channel's RK4 sub-batch (None when every row is bound)."""

    th: torch.Tensor      # (n, d) work dtype
    thc: torch.Tensor     # (n, d) work dtype
    t_rel: float
    sub: TrajState | None = None


def supports_exact_morse(potential, state) -> bool:
    """The map applies to a non-harmonic separable MorsePotential with the
    state in the diagonal-monodromy representation."""
    from semiclassical_tpu_torch.potentials.model import MorsePotential

    return (isinstance(potential, MorsePotential) and not potential.harmonic
            and state.diag_monodromy)


def _setup(q, p, S0, a, D, dt):
    """The float64 constants of the map at the state (q, p, S0), and the
    per-element eps before the cleanup. Elements with eps > EPS_EXACT (or
    not finite) are replaced by the rest state before any constant is
    derived, so every closed-form row is finite; their rows ride the
    side-channel."""
    a = a[None, :]
    D = D[None, :]
    w0 = a * torch.sqrt(2.0 * D)
    em_raw = torch.expm1(-a * q)
    eps_raw = (0.5 * p * p + D * em_raw * em_raw) / D
    bad_elem = ~(eps_raw <= EPS_EXACT)
    q = torch.where(bad_elem, 0.0, q)
    p = torch.where(bad_elem, 0.0, p)
    em = torch.expm1(-a * q)
    V = D * em * em
    E = 0.5 * p * p + V
    eps = E / D
    one_m_eps = 1.0 - eps
    s = torch.sqrt(eps)
    rt = torch.sqrt(one_m_eps)
    wE = w0 * rt
    wpE = -w0 / (2.0 * rt)
    # phase: s cos th0 = eps - (1-eps) expm1(a q),
    #        s sin th0 = a p (1-eps) e^{a q} / wE
    em2 = torch.expm1(a * q)
    eaq = em2 + 1.0
    cos_part = eps - one_m_eps * em2
    sin_part = a * p * one_m_eps * eaq / wE
    th0 = torch.atan2(sin_part, cos_part)
    # Jhat(th0) and its inverse through the analytic det(Jhat) = D / wE
    sn0, cs0 = torch.sin(th0), torch.cos(th0)
    den0 = 1.0 - s * cs0
    r0 = 1.0 / den0
    J11 = sn0 * r0 / a
    J21 = (wE / a) * (cs0 - s) * r0 * r0
    J12 = (-cs0 * r0 / 2.0 + s / one_m_eps) / a
    J22 = sn0 * ((wpE * eps + wE / 2.0) / a * r0
                 + (s * wE / (2.0 * a)) * cs0 * r0 * r0)
    idet = wE / D
    # action: S(t) = S0 + A t + P(th) - P(th0), with the periodic part
    # P(th) = pc1 g(th) + pc2 sin th / den,  g = 2 atan2(beta sn, 1-beta cs)
    beta = s / (1.0 + rt)
    pc2 = -2.0 * D * one_m_eps * s / wE
    g0 = 2.0 * torch.atan2(beta * sn0, 1.0 - beta * cs0)
    P0 = (2.0 * D / w0) * g0 + pc2 * sn0 * r0
    # every quantity of the map is 2 pi-periodic in th (the explicit time
    # rides t_rel), so whole periods drop from the constant increment: |th|
    # stays <= 2 pi at the per-step wrap for any dt
    wdt = wE * dt
    wdt = wdt - (2.0 * np.pi) * torch.round(wdt / (2.0 * np.pi))
    consts = dict(
        s=s, qoff=-torch.log1p(-eps) / a, pamp=s * wE / a, cE=wE / a,
        c12b=s / one_m_eps / a,
        c22a=(wpE * eps + wE / 2.0) / a, c22b=s * wE / (2.0 * a),
        bco=eps * wpE, j011=J22 * idet, j012=-J12 * idet, j021=-J21 * idet,
        j022=J11 * idet, beta=beta, pc2=pc2, wdt=wdt,
        A=torch.sum(E - 2.0 * D * (1.0 - rt), dim=1),
        S_base=S0 - torch.sum(P0, dim=1))
    return consts, th0, torch.sum(E, dim=1), eps_raw


def build_morse_map(state: TrajState, potential, dt, group=None):
    """(MorseMapPack, MorseMapCarry) of the map at the current state, at the
    state's work dtype (q's). Rows with a mode of eps > EPS_EXACT, or a
    non-finite value, are routed to the RK4 side-channel; raises ValueError
    for a harmonic or non-Morse potential, a dense monodromy, non-unit
    masses, or when more than RK4_FRACTION_MAX of the batch would be
    routed.

    Under a process `group` the state is this rank's shard: the routed
    rows and the identity test of the monodromy are counted over the
    group (one all-reduce), so every rank takes the same decision and
    raises together or not at all; the side-channel holds this shard's
    routed rows."""
    from semiclassical_tpu_torch.potentials.model import MorsePotential

    if not isinstance(potential, MorsePotential) or potential.harmonic:
        raise ValueError(
            "the exact integrator requires a non-harmonic MorsePotential "
            f"(got {type(potential).__name__}); use integrator='rk4'")
    if not state.diag_monodromy:
        raise ValueError(
            "the exact integrator requires the diagonal-monodromy "
            "representation (automatic for separable potentials)")
    if not np.allclose(potential.masses().cpu().numpy(), 1.0):
        raise ValueError("the exact Morse map assumes unit masses")

    f64 = torch.float64
    wdtype = state.q.dtype
    q, p = state.q.to(f64), state.p.to(f64)
    if state.compensated:
        # a resumed or edited comp32 state carries residuals
        q, p = q + state.qc.to(f64), p + state.pc.to(f64)
    a, D = potential.a.to(f64), potential.D.to(f64)
    consts, th0, e_row, eps = _setup(q, p, state.S.to(f64), a, D, float(dt))
    n = state.q.shape[0]
    # ~all(<=) rather than any(>): NaN rows are routed too, where RK4
    # carries the NaN into the energies and the energy guard raises, as
    # it does under integrator='rk4'
    bad_row = ~torch.all(eps <= EPS_EXACT, dim=1)
    Z = state.Z
    not_identity = ~((Z[0] == 1.0) & (Z[3] == 1.0) & (Z[1] == 0.0)
                     & (Z[2] == 0.0))
    counts = torch.stack([bad_row.sum(), not_identity.sum()])
    n_bad_here = int(counts[0])
    n_bad, n_moved = group_sum([counts], group)[0].tolist()
    n_all = n * (1 if group is None else group.world)
    if n_bad > RK4_FRACTION_MAX * n_all:
        raise ValueError(
            f"exact Morse map: {n_bad}/{n_all} trajectories have a mode with "
            f"eps = E/D > {EPS_EXACT} (unbound or near-separatrix) — the "
            "ensemble is too hot for the closed-form map; use "
            "integrator='rk4'")
    sub_idx = sub = None
    if n_bad_here:
        sub_idx = torch.nonzero(bad_row).flatten()
        rows = lambda x: None if x is None else x[sub_idx]
        sub = TrajState(q=state.q[sub_idx], p=state.p[sub_idx],
                        Z=state.Z[:, sub_idx], S=state.S[sub_idx],
                        qc=rows(state.qc), pc=rows(state.pc))
    if n_bad:
        logger.info("exact Morse map: %d/%d rows RK4-routed (eps > %s)",
                    n_bad, n_all, EPS_EXACT)
    work = {k: v.to(wdtype) for k, v in consts.items()
            if k not in ("A", "S_base", "bco", "wdt")}
    bco_hi, bco_lo = _split_hi_lo(consts["bco"], wdtype)
    wdt_hi, wdt_lo = _split_hi_lo(consts["wdt"], wdtype)
    th_hi, th_lo = _split_hi_lo(th0, wdtype)
    inv_a = (1.0 / a).to(wdtype)
    pack = MorseMapPack(
        **work, A=consts["A"], S_base=consts["S_base"],
        bco_hi=bco_hi, bco_lo=bco_lo, wdt_hi=wdt_hi, wdt_lo=wdt_lo,
        inv_a=inv_a, c12a=0.5 * inv_a,
        pc1=(2.0 * D / (a * torch.sqrt(2.0 * D))).to(wdtype),
        e_bound_sum=torch.sum(torch.where(bad_row, 0.0, e_row)),
        m0=Z if n_moved else None, sub_idx=sub_idx, mono_dtype=Z.dtype,
        compensated=state.compensated)
    return pack, MorseMapCarry(th=th_hi, thc=th_lo, t_rel=0.0, sub=sub)


def morse_map_state(pack: MorseMapPack, carry: MorseMapCarry) -> TrajState:
    """The state at the carry's phase and time: q, p, the monodromy planes
    (composed with M0 where the setup state was not at the identity, then
    cast to the state's monodromy dtype), S (float64 under comp32, with
    zero residuals qc, pc) and the side-channel rows scattered in."""
    th, thc = carry.th, carry.thc
    sn0, cs0 = torch.sin(th), torch.cos(th)
    # first-order residual correction: sin/cos at th + thc
    sn = sn0 + thc * cs0
    cs = cs0 - thc * sn0
    den = 1.0 - pack.s * cs
    r = 1.0 / den
    r2 = r * r
    q = torch.log(den) * pack.inv_a[None, :] + pack.qoff
    p = pack.pamp * sn * r
    j11 = sn * r * pack.inv_a[None, :]
    j21 = pack.cE * (cs - pack.s) * r2
    j12 = pack.c12b - cs * r * pack.c12a[None, :]
    j22 = sn * (pack.c22a * r + pack.c22b * cs * r2)
    # shear entry b = eps wpE t: a two-product of the (hi, lo) rate and the
    # float64 time split at the work dtype
    t_hi, t_lo = _split_float(carry.t_rel, th.dtype)
    b = pack.bco_hi * t_hi + (pack.bco_hi * t_lo + pack.bco_lo * t_hi)
    m11 = pack.j011 + b * pack.j021
    m12 = pack.j012 + b * pack.j022
    mqq = j11 * m11 + j12 * pack.j021
    mqp = j11 * m12 + j12 * pack.j022
    mpq = j21 * m11 + j22 * pack.j021
    mpp = j21 * m12 + j22 * pack.j022
    if pack.m0 is not None:
        m0qq, m0qp, m0pq, m0pp = pack.m0
        mqq, mqp, mpq, mpp = (mqq * m0qq + mqp * m0pq, mqq * m0qp + mqp * m0pp,
                              mpq * m0qq + mpp * m0pq, mpq * m0qp + mpp * m0pp)
    g = 2.0 * torch.atan2(pack.beta * sn, 1.0 - pack.beta * cs)
    P = pack.pc1[None, :] * g + pack.pc2 * sn * r
    S = pack.S_base + pack.A * carry.t_rel + torch.sum(P, dim=1).to(
        torch.float64)
    qc = pc = None
    if pack.compensated:
        qc, pc = torch.zeros_like(q), torch.zeros_like(p)
    else:
        S = S.to(q.dtype)
    Z = torch.stack([mqq, mqp, mpq, mpp]).to(pack.mono_dtype)
    if carry.sub is not None:
        idx, sub = pack.sub_idx, carry.sub
        q.index_copy_(0, idx, sub.q)
        p.index_copy_(0, idx, sub.p)
        Z.index_copy_(1, idx, sub.Z)
        S.index_copy_(0, idx, sub.S)
        if pack.compensated:
            qc.index_copy_(0, idx, sub.qc)
            pc.index_copy_(0, idx, sub.pc)
    return TrajState(q=q, p=p, Z=Z, S=S, qc=qc, pc=pc)


def morse_map_advance(pack: MorseMapPack, carry: MorseMapCarry, dt,
                      potential):
    """One step: th += wE dt through the Neumaier two-sum (the lo parts of
    the increment and of 2 pi folded into the residual), wrapped to
    [-pi, pi], and one RK4 step of the side-channel. Returns (new carry,
    batch-mean energy at the step start, float64): the closed-form rows'
    energy is a constant of the motion, the side-channel rows add their
    current T + V, so the energy guard still watches them."""
    th, thc = _comp_accumulate(carry.th, carry.thc + pack.wdt_lo,
                               pack.wdt_hi)
    tp_hi, tp_lo = _split_float(2.0 * math.pi, th.dtype)
    k = torch.round(th * (1.0 / (2.0 * math.pi)))
    th = th - k * tp_hi              # exact: k in {-1, 0, 1}
    thc = thc - k * tp_lo
    n = th.shape[0]
    energy = pack.e_bound_sum / n
    sub = carry.sub
    if sub is not None:
        sub, e_sub = rk4_step(sub, potential, dt)
        energy = (pack.e_bound_sum + sub.q.shape[0] * e_sub.to(
            torch.float64)) / n
    return MorseMapCarry(th=th, thc=thc, t_rel=carry.t_rel + float(dt),
                         sub=sub), energy
