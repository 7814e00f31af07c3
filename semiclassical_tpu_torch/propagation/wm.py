# coding: utf-8
"""Walton-Manolopoulos (WM) semiclassical IVR propagator.

[WM] A. Walton, D. Manolopoulos, Mol. Phys. 87, 961-978 (1996)

The WM propagator is the Filinov-smoothed, cell-integrated variant of HK:
the function L = log C + i S / hbar is expanded to quadratic order around
each initial phase-space point and the integral over a phase-space cell of
widths ~ alpha^{-1/2}, beta^{-1/2} is carried out analytically, giving
per-trajectory Gaussian parameter tensors (eqns. 50-84) and modified
observables (eqns. 85-100).

The port of `semiclassical_tpu.propagation.wm` (float64/complex128) on the
dense path (any width matrix, rank-deficient included) and on the separable
path (all widths diagonal at full rank, `scan_diag`):

* everything that touches the 2d-dimensional phase space is built in the
  projected non-zero subspace of dimension 2r (U from the sampling);
* the b0 vector of eqn. 55 is identically zero in the WM approximation, so
  eps and PIq (eqns. 72, 74) depend only on the initial momenta and are
  batch constants;
* the time loop (`WaltonManolopoulosPropagator`, through the HK
  propagator's hooks) runs the scan fast path `wm_scan_derived`: every
  observable is a scalar bilinear form that comes from ONE per-step solve
  Y = At^{-1} P of the balanced, scaled A-matrix (`linalg.
  batched_det_solve_blocks`: two calls of the CUDA kernel K2 on the card)
  and one solve of the M-matrix against a stack of five vectors (one more
  K2 call). No (n, d, d) tensor is formed per step;
* the full-tensor `wm_derived` (eqns. 50-84, with the det + inverse kernel
  K3 on the A- and M-matrices) builds the sign trackers once per batch and
  is the oracle of the fast path (`wm_observables`);
* on the separable path the A- and M-matrices decouple into per-mode 2x2
  complex systems (`WMDiagConsts`, `_wm_diag_core`), and the whole
  time-dependent chain of a step — the 2x2 algebra, the mode-sum Gram
  forms and the per-mode det planes — is one call of `ops.wm_diag`: the
  fused CUDA kernel K5 on the card (`_wm_scan_derived_diag`);
* the observables' per-trajectory contributions also give the second
  moments of the error bars, and the HK propagator's time loop runs the
  micro-batches;
* the coefficients (eqn. 75, in log space), the grid wavefunction and the
  O(n^2) norm (`wm_norm`) read the full tensors of `wm_derived`; each
  (bi, bj) block pair of the norm inverts its (bi bj, r, r) pair matrices
  with `linalg.batched_det_inv`: K3 on the card;
* the exact integrators come with the HK propagator's time loop;
* the precision modes as for HK: the packs and the whole A/M algebra at
  the propagator's `dtype` (complex64 in the reduced modes, so K2, K3 and
  K5 run at complex64 / float32), the displacements at the trajectory
  precision with the comp32 residuals folded in, then cast to `dtype`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.ops import wm_diag as _wm_diag_ops
from semiclassical_tpu_torch.propagation.hk import (BatchConstants, HKParams,
                                                    HermanKlukPropagator,
                                                    _device_facs,
                                                    _divisor_block, _moments,
                                                    _no_sampled_ring, _only,
                                                    _pair_sum, _sqrt_norm,
                                                    hk_batch_constants,
                                                    hk_prefactor_det,
                                                    pair_block,
                                                    subsampled_pair_sum)
from semiclassical_tpu_torch.propagation.state import SignTracker, TrajState
from semiclassical_tpu_torch.units import hbar

__all__ = ["WMParams", "WMDiagConsts", "WMBatchConstants", "WMDerived",
           "WMScanDerived", "WMTrackers", "WaltonManolopoulosPropagator",
           "wm_batch_constants", "wm_derived", "wm_scan_derived",
           "wm_scan_observables", "wm_scan_observables_qp",
           "wm_autocorr_qp", "wm_observables", "wm_diag_inputs",
           "wm_coefficients", "wm_log_coefficients", "wm_wavefunction",
           "wm_norm", "wm_pair_bytes"]


@dataclass(frozen=True)
class WMDiagConsts:
    """Per-mode constants of the separable all-diagonal WM path.

    Valid when Gamma_0, Gamma_i, Gamma_t are all diagonal and rank == dim:
    every block of the balanced A-matrix (eqn. 50) is then diagonal, so A
    decouples into d independent 2x2 complex systems per trajectory, and
    the projections, solves and determinants of `wm_scan_derived` collapse
    to elementwise (n, d) arithmetic and mode products. Every field is a
    real (d,) vector; purely imaginary constants are kept as their
    imaginary part (`*_im`).
    """

    u1: torch.Tensor        # Dbal q-column scale / sqrt(s) = 1/sqrt(g0 s)
    u2: torch.Tensor        # Dbal p-column scale / sqrt(s) = sqrt(g0 / s)
    gt: torch.Tensor        # Gamma_t diagonal
    g0: torch.Tensor        # Gamma_0 diagonal
    cb11: torch.Tensor      # A_const_b^T [0,0] = (2 alpha g0 + gi)/(g0 s)
    cb12_im: torch.Tensor   # A_const_b^T [0,1] / i = -2/(hbar s)
    cb22: torch.Tensor      # A_const_b^T [1,1] = 2 beta / s
    fq1: torch.Tensor       # Fq q-column: g0 gi u1 / (g0 + gi)
    fq2_im: torch.Tensor    # Fq p-column / i: -g0 u2 / (hbar (g0 + gi))
    bq1: torch.Tensor       # BqUb q-column: gi u1
    bq2_im: torch.Tensor    # BqUb p-column / i: -u2 / hbar
    c2_11: torch.Tensor     # C2b [0,0] = gi^2 u1^2 / (g0 + gi)
    c2_12_im: torch.Tensor  # C2b [0,1] / i = -gi u1 u2 / (hbar (g0 + gi))
    c2_22: torch.Tensor     # C2b [1,1] = -u2^2 / (hbar^2 (g0 + gi))
    m0: torch.Tensor        # M0 diagonal: g0 + gt
    cqq: torch.Tensor       # Cqq diagonal: g0 gi / (g0 + gi)
    ig0i: torch.Tensor      # [Gi + G0]^{-1} diagonal: 1 / (g0 + gi)


def _diag_consts(Gamma_i, Gamma_t, Gamma_0, alpha, beta):
    """The WMDiagConsts fields (host numpy) of diagonal widths."""
    g0, gi, gt = (np.diag(G).astype(np.float64)
                  for G in (Gamma_0, Gamma_i, Gamma_t))
    s_ab = 2.0 * np.sqrt(alpha * beta)
    sc = 1.0 / np.sqrt(s_ab)
    u1 = 1.0 / np.sqrt(g0) * sc
    u2 = np.sqrt(g0) * sc
    gi0 = g0 + gi
    vec = lambda x: np.broadcast_to(x, g0.shape)
    return dict(
        u1=u1, u2=u2, gt=gt, g0=g0,
        cb11=(2.0 * alpha * g0 + gi) / (g0 * s_ab),
        cb12_im=vec(-2.0 / (hbar * s_ab)), cb22=vec(2.0 * beta / s_ab),
        fq1=g0 * gi * u1 / gi0, fq2_im=-g0 * u2 / (hbar * gi0),
        bq1=gi * u1, bq2_im=-u2 / hbar,
        c2_11=gi**2 * u1**2 / gi0, c2_12_im=-gi * u1 * u2 / (hbar * gi0),
        c2_22=-u2**2 / (hbar**2 * gi0),
        m0=g0 + gt, cqq=g0 * gi / gi0, ig0i=1.0 / gi0)


@dataclass(frozen=True)
class WMParams:
    """Constant parameter pack of the WM propagator.

    Pseudo-determinants absorb their pi / 2 pi factors as in the JAX
    package. The M-matrix determinant is kept SCALED: detM = det(M' /
    m_scale) with m_scale = 2 pi exp(m_log_det / r), so that it is O(1) at
    any mode count; the compensation exp(-m_log_det / 2) is folded into
    `auto_pref`.
    """

    hk: HKParams
    U: torch.Tensor          # (d, r)  non-zero subspace of Gamma_i + Gamma_0
    iGi0: torch.Tensor       # (d, d)  pseudo-inverse of Gamma_i + Gamma_0
    G0: torch.Tensor         # (d, d)  Gamma_0
    Gt: torch.Tensor         # (d, d)  Gamma_t
    A_const: torch.Tensor    # (2r, 2r) complex: 2 F' + [[U^T Gi U, 0], [0, 0]]
                             #   - 2i/hbar [[0, 0], [I_r, 0]]
    BqU: torch.Tensor        # (d, 2r) complex: [Gi U, -i/hbar U]
    G0U: torch.Tensor        # (d, r)  Gamma_0 U
    UtG0U: torch.Tensor      # (r, r)  U^T Gamma_0 U
    Cqq: torch.Tensor        # (d, d)  G0 - G0 [Gi+G0]^{-1} G0  (eqn. 69)
    G0iGi0: torch.Tensor     # (d, d)  G0 [Gi+G0]^{-1}
    Dbal: torch.Tensor       # (2r, 2r) blockdiag(W^{-1/2}, W^{1/2}),
                             # W = U^T G0 U: det-preserving balancing of A
    # scan fast path: U1 = U W^{-1/2} / sqrt(s), U2 = U W^{1/2} / sqrt(s),
    # s = 2 sqrt(alpha beta) — projecting with them IS the balancing
    # conjugation D (.) D / s
    U1: torch.Tensor         # (d, r)
    U2: torch.Tensor         # (d, r)
    A_const_b: torch.Tensor  # (2r, 2r) complex  D A_const D / s
    BqUb: torch.Tensor       # (d, 2r) complex  Bq U2r D / sqrt(s)
    Fq: torch.Tensor         # (d, 2r) complex  G0 [Gi+G0]^{-1} BqUb
    C2b: torch.Tensor        # (2r, 2r) complex BqUb^T [Gi+G0]^{-1} BqUb
    M0: torch.Tensor         # (r, r)  U^T (G0 + Gt) U
    alpha: float
    beta: float
    auto_pref: float         # detG0^{1/2} detGt^{1/4} detGi^{1/4} / detGi0^{1/2}
                             # / exp(m_log_det / 2), combined in log space
    m_scale: float           # 2 pi exp(m_log_det / r)
    m_log_det: float         # log of the factored-out detM scale
    log_coef_pref: float     # log of detG0^{1/4} detGt^{1/4} detGi^{1/4}
                             # / detGi0^{1/2}, the coefficients' prefactor
    dim: int
    rank: int
    scan_diag: bool          # all widths diagonal at full rank: the
                             # separable path (per-mode 2x2 algebra)
    diag: WMDiagConsts | None = None     # per-mode constants (scan_diag)
    diag_pack: torch.Tensor | None = None  # (17, d) K5's constant pack

    @property
    def coef_pref(self):
        return float(np.exp(self.log_coef_pref))

    @property
    def dtype(self):
        """The real dtype of the pack and the A/M algebra."""
        return self.Gt.dtype

    @property
    def cdtype(self):
        return linalg.complex_dtype(self.Gt.dtype)

    @staticmethod
    def from_arrays(hk, device, *, alpha, beta, auto_pref, m_scale,
                    m_log_det, log_coef_pref, dim, rank, scan_diag,
                    diag=None, dtype=torch.float64, **arrays):
        """Pack host arrays (real -> `dtype`, complex -> its complex type)
        for the device; `arrays` holds every tensor field, `diag` the
        WMDiagConsts fields (scan_diag only)."""
        cdtype = linalg.complex_dtype(dtype)

        def t(x):
            x = np.asarray(x)
            if np.iscomplexobj(x):
                return torch.tensor(x.astype(np.complex128), device=device,
                                    dtype=cdtype)
            return torch.tensor(x.astype(np.float64), device=device,
                                dtype=dtype)

        dg = pack = None
        if diag is not None:
            dg = WMDiagConsts(**{k: t(v) for k, v in diag.items()})
            pack = _wm_diag_ops.build_const_pack(dg, hk.p0.to(dtype),
                                                 float(m_scale))
        return WMParams(hk=hk, **{k: t(v) for k, v in arrays.items()},
                        alpha=float(alpha), beta=float(beta),
                        auto_pref=float(auto_pref), m_scale=float(m_scale),
                        m_log_det=float(m_log_det),
                        log_coef_pref=float(log_coef_pref), dim=int(dim),
                        rank=int(rank), scan_diag=bool(scan_diag), diag=dg,
                        diag_pack=pack)


def _build_wm_params(hk, Gamma_i, Gamma_t, Gamma_0, U, iGi0, alpha, beta,
                     device, dtype=torch.float64):
    """WMParams from the HK pack, the width matrices and the sampling
    subspace U (d, r) / pseudo-inverse iGi0 (host numpy), at `dtype`."""
    Gamma_i = np.asarray(Gamma_i, dtype=np.float64)
    Gamma_t = np.asarray(Gamma_t, dtype=np.float64)
    Gamma_0 = np.asarray(Gamma_0, dtype=np.float64)
    U = np.asarray(U, dtype=np.float64)
    iGi0 = np.asarray(iGi0, dtype=np.float64)
    d, r = U.shape
    iG0 = linalg.pseudo_inverse(Gamma_0)
    G0iGi0 = Gamma_0 @ iGi0

    # A's constant part in the projected 2r space:
    #   2 blockdiag(alpha U^T G0 U, beta U^T iG0 U)
    #   + [[U^T Gi U, 0], [0, 0]] - 2i/hbar [[0, 0], [I_r, 0]]
    A_const = np.zeros((2 * r, 2 * r), dtype=np.complex128)
    A_const[:r, :r] = 2.0 * alpha * (U.T @ Gamma_0 @ U) + U.T @ Gamma_i @ U
    A_const[r:, r:] = 2.0 * beta * (U.T @ iG0 @ U)
    A_const[r:, :r] = -2j / hbar * np.eye(r)
    # Bq U2 = [Gi U, -i/hbar U]  (eqn. 54 projected; constant)
    BqU = np.concatenate([Gamma_i @ U, (-1j / hbar) * U], axis=1)

    # the pseudo-determinant prefactors combine in log space (the
    # individual determinants under/overflow for many modes); dividing M'
    # by m_scale = 2 pi exp(m_log_det / r) keeps detM O(1), and the
    # compensator exp(-m_log_det / 2) cancels the 0.5 ld0 of auto_pref
    ld0 = linalg.pseudo_logdet(Gamma_0, scale=np.pi)
    ldi = linalg.pseudo_logdet(Gamma_i, scale=np.pi)
    ldt = linalg.pseudo_logdet(Gamma_t, scale=np.pi)
    ldi0 = linalg.pseudo_logdet(Gamma_0 + Gamma_i, scale=2 * np.pi)
    m_log_det = float(ld0)
    auto_pref = np.exp(0.25 * ldt + 0.25 * ldi - 0.5 * ldi0)

    # determinant-preserving balancing of A: blockdiag(W^{-1/2}, W^{1/2}),
    # W = U^T G0 U. det(D) = 1, and the conjugation brings every block of
    # A / (2 sqrt(alpha beta)) to O(1), which the unpivoted eliminations
    # of the Gauss-Jordan kernels need
    W = U.T @ Gamma_0 @ U
    ew, Vw = np.linalg.eigh(W)
    W_sqrt = (Vw * np.sqrt(ew)) @ Vw.T
    W_isqrt = (Vw / np.sqrt(ew)) @ Vw.T
    Dbal = np.zeros((2 * r, 2 * r))
    Dbal[:r, :r] = W_isqrt
    Dbal[r:, r:] = W_sqrt

    # scan fast path: fold the balancing D and the 1/s scale into the
    # projectors, so the projected monodromy assembles Ab = D (A/s) D
    # directly and iA = (D/sqrt(s)) iAb (D/sqrt(s)) re-absorbs into the
    # same balanced operands downstream
    s_ab = 2.0 * np.sqrt(alpha * beta)
    sc = 1.0 / np.sqrt(s_ab)
    U1 = U @ W_isqrt * sc
    U2 = U @ W_sqrt * sc
    BqUb = np.concatenate([Gamma_i @ U1, (-1j / hbar) * U2], axis=1)

    # separable all-diagonal detection, as the JAX package: exact-zero
    # off-diagonals at full rank
    def _isdiag(M):
        return float(np.abs(M - np.diag(np.diag(M))).max()) == 0.0

    scan_diag = (r == d and _isdiag(Gamma_0) and _isdiag(Gamma_i)
                 and _isdiag(Gamma_t))
    return WMParams.from_arrays(
        hk, device, U=U, iGi0=iGi0, G0=Gamma_0, Gt=Gamma_t, A_const=A_const,
        BqU=BqU, G0U=Gamma_0 @ U, UtG0U=W,
        Cqq=Gamma_0 - Gamma_0 @ iGi0 @ Gamma_0, G0iGi0=G0iGi0, Dbal=Dbal,
        U1=U1, U2=U2, A_const_b=Dbal @ A_const @ Dbal / s_ab, BqUb=BqUb,
        Fq=G0iGi0 @ BqUb, C2b=BqUb.T @ iGi0 @ BqUb,
        M0=U.T @ (Gamma_0 + Gamma_t) @ U,
        alpha=alpha, beta=beta, auto_pref=auto_pref,
        m_scale=2.0 * np.pi * np.exp(m_log_det / r), m_log_det=m_log_det,
        log_coef_pref=0.25 * (ld0 + ldt + ldi) - 0.5 * ldi0,
        dim=d, rank=r, scan_diag=scan_diag,
        diag=(_diag_consts(Gamma_i, Gamma_t, Gamma_0, alpha, beta)
              if scan_diag else None), dtype=dtype)


@dataclass(frozen=True)
class WMBatchConstants:
    """HK batch constants plus WM-specific initial-point quantities."""

    base: BatchConstants
    eps: torch.Tensor   # (n,)   eqn. 74 with b0 = 0 (time-independent)
    PIq: torch.Tensor   # (n, d) eqn. 72 with pi_i = p (time-independent)
    n1q: torch.Tensor   # (n, d) -hbar^2 tau1(q)/m
    n2q: torch.Tensor   # (n,)   -hbar^2/2 sum_k tau2_k(q)/m_k
    z0: torch.Tensor    # (n, 2r) complex  BqUb^T [Gi+G0]^{-1} (p0 - pi)

    @property
    def weight_scale(self):
        return self.base.weight_scale


@dataclass(frozen=True)
class WMDerived:
    """Per-step derived tensors of the WM propagator (eqns. 50-84)."""

    detA: torch.Tensor   # (n,) complex  det(A' / 2 sqrt(alpha beta))
    detM: torch.Tensor   # (n,) complex  det(M' / m_scale)
    CQQ: torch.Tensor    # (n, d, d) complex  (eqn. 70)
    CqQ: torch.Tensor    # (n, d, d) complex  (eqn. 71)
    PIQ: torch.Tensor    # (n, d) complex     (eqn. 73)
    Rqq: torch.Tensor    # (n, d, d) complex  (eqn. 79)
    RQQ: torch.Tensor    # (n, d, d) complex  (eqn. 80)
    RqQ: torch.Tensor    # (n, d, d) complex  (eqn. 81)
    Pq: torch.Tensor     # (n, d) complex     (eqn. 82)
    PQ: torch.Tensor     # (n, d) complex     (eqn. 83)
    gamma: torch.Tensor  # (n,) complex       (eqn. 84)


@dataclass(frozen=True)
class WMScanDerived:
    """Per-trajectory scalars — everything eqns. 85-100 need."""

    detA: torch.Tensor    # (n,) complex  det(A'/2 sqrt(alpha beta))
    detM: torch.Tensor    # (n,) complex  det(M'/m_scale)
    gamma: torch.Tensor   # (n,) complex  eqn. 84
    rqq: torch.Tensor     # (n,) complex  dq^T Rqq dq
    rQQ: torch.Tensor     # (n,) complex  dQ^T RQQ dQ
    rqQ: torch.Tensor     # (n,) complex  dq^T RqQ dQ
    Pq_dq: torch.Tensor   # (n,) complex  Pq . dq
    PQ_dQ: torch.Tensor   # (n,) complex  PQ . dQ
    kfac: torch.Tensor    # (n,) complex  nacqQ + nacQ nacq  (eqns. 89-100)


# ---------------------------------------------------------------------------
# batch constants and displacements
# ---------------------------------------------------------------------------

def _center_minus(x0, x0c, xi):
    """x0 - xi at the sampling precision (xi's: float64 under comp32, whose
    center is split as x0 + x0c and recombined at xi's dtype first)."""
    x0f = x0.to(xi.dtype)
    if x0c is not None:
        x0f = x0f + x0c.to(xi.dtype)
    return x0f[None, :] - xi


def _dQ_evolved(hk: HKParams, state: TrajState):
    """q0 - q(t) at trajectory-difference precision: under comp32 the
    residuals of the center and of the state fold in."""
    dQ = hk.q0[None, :] - state.q.to(hk.q0.dtype)
    if state.compensated and hk.q0c is not None:
        dQ = dQ + (hk.q0c - state.qc)
    return dQ


def _dp_evolved(hk: HKParams, state: TrajState):
    """p(t) - p0, with the comp32 residuals folded in."""
    dp = state.p.to(hk.p0.dtype) - hk.p0[None, :]
    if state.compensated and hk.p0c is not None:
        dp = dp + (state.pc - hk.p0c)
    return dp


def _displacements(params: WMParams, bc: WMBatchConstants, state: TrajState):
    """dq = q0 - q(0) and dQ = q0 - q(t), (n, d) each, at trajectory
    precision (the comp32 residuals folded in)."""
    hk = params.hk
    return _center_minus(hk.q0, hk.q0c, bc.base.qi), _dQ_evolved(hk, state)


def _nac_terms(potential, x):
    """n1 = -hbar^2 tau1/m (n, d), n2 = -hbar^2/2 sum_k tau2_k/m_k (n,)
    (eqns. 89-90)."""
    inv_m = 1.0 / potential.masses()
    tau1 = potential.derivative_coupling_1st(x)
    tau2 = potential.derivative_coupling_2nd(x)
    n1 = -(hbar**2) * tau1 * inv_m[None, :]
    n2 = -(hbar**2) * 0.5 * torch.sum(tau2 * inv_m[None, :], dim=1)
    return n1, n2


def wm_batch_constants(params: WMParams, qi, pi, log_prob,
                       potential, group=None) -> WMBatchConstants:
    """The HK batch constants plus eps, PIq, the initial-point NAC terms
    and z0: the difference p0 - pi at the sampling precision, the (d, d)
    contractions at the pack's dtype. Under a process `group` the weights
    are the batch's, as in `hk_batch_constants`."""
    base = hk_batch_constants(params.hk, qi, pi, log_prob, potential, group)
    t = params.dtype
    dp0 = _center_minus(params.hk.p0, params.hk.p0c, pi).to(t)
    eps = -(0.5 / hbar**2) * torch.einsum("na,ab,nb->n", dp0, params.iGi0,
                                          dp0)
    PIq = params.hk.p0.to(t)[None, :] - dp0 @ params.G0iGi0.T
    n1q, n2q = _nac_terms(potential, qi)
    z0 = torch.einsum("ia,ni->na", params.BqUb,
                      (dp0 @ params.iGi0).to(params.cdtype))
    return WMBatchConstants(base=base, eps=eps, PIq=PIq, n1q=n1q, n2q=n2q,
                            z0=z0)


# ---------------------------------------------------------------------------
# full-tensor derived quantities (trackers, oracle)
# ---------------------------------------------------------------------------

def _mono_proj(M, U):
    """M @ U for a dense (n, d, d) monodromy block, or the row scale
    diag(M) U for the (n, d) diagonal representation."""
    return M @ U if M.dim() == 3 else M[:, :, None] * U[None]


def wm_derived(params: WMParams, bc: WMBatchConstants,
               state: TrajState) -> WMDerived:
    """All per-trajectory WM tensors for the current state (eqns. 50-84),
    at the pack's dtype."""
    cd = params.cdtype
    c = lambda x: x.to(cd)
    U = params.U                                            # (d, r)
    Uc = c(U)
    p0 = params.hk.p0
    Z = state.Z.to(params.dtype)
    st = dataclasses.replace(state, Z=Z)

    # project monodromy blocks once: (n, d, r)
    MqzU = torch.cat([_mono_proj(st.Mqq, U), _mono_proj(st.Mqp, U)],
                     dim=2)                                 # (n, d, 2r)
    MpqU, MppU = _mono_proj(st.Mpq, U), _mono_proj(st.Mpp, U)
    MpzU = torch.cat([MpqU, MppU], dim=2)                   # (n, d, 2r)
    MqqU, MqpU = MqzU.split(U.shape[1], dim=2)

    # hess(L)' = i/hbar [[Mpq^T Mqq, Mpq^T Mqp], [Mqp^T Mpq, Mqp^T Mpp]]
    # projected (eqns. A6-A9)
    hessL = (1j / hbar) * torch.cat([
        torch.einsum("nia,nib->nab", MpqU, MqzU),
        torch.einsum("nia,nib->nab", MqpU, MpzU)], dim=1)   # (n, 2r, 2r)

    # A' (eqn. 50 projected)
    GtMqzU = torch.einsum("ij,njb->nib", params.Gt, MqzU)   # (n, d, 2r)
    A = (params.A_const[None] - hessL
         + c(torch.einsum("nia,nib->nab", MqzU, GtMqzU))
         + 1j * (torch.einsum("nia,nib->nab", MpzU, MqzU) * (2.0 / hbar)))

    # det(A / 2 sqrt(alpha beta)) is O(1) (its alpha, beta -> oo limit is
    # (2 sqrt(alpha beta))^{2r}); balanced before the elimination (det
    # Dbal = 1), inv(A) = D inv(Abal) D / s
    s_ab = 2.0 * math.sqrt(params.alpha * params.beta)
    D = c(params.Dbal)
    Abal = torch.einsum("ab,nbc,cd->nad", D, A / s_ab, D)
    detA, iAb = linalg.batched_det_inv(Abal)
    iA = torch.einsum("ab,nbc,cd->nad", D, iAb, D) / s_ab   # (n, 2r, 2r)

    # BQ U2 = Gt Mqz U2 + i/hbar Mpz U2 (eqn. 53 projected)
    BQU = c(GtMqzU) + 1j * (MpzU / hbar)                    # (n, d, 2r)
    # eqn. 57: Gt(t) = Gt - BQ iA BQ^T;  eqn. 59: Gti = BQ iA Bq^T
    iA_BQ = torch.einsum("nab,njb->naj", iA, BQU)           # (n, 2r, d)
    Gt_t = c(params.Gt)[None] - torch.einsum("nia,naj->nij", BQU, iA_BQ)
    iA_Bq = torch.einsum("nab,jb->naj", iA, params.BqU)     # (n, 2r, d)
    Gti = torch.einsum("nia,naj->nij", BQU, iA_Bq)          # (n, d, d)

    # eqns. 68-73 (with pi_i = p, pi_t = P since b0 = 0)
    Gti_iGi0 = torch.einsum("nij,jk->nik", Gti, c(params.iGi0))
    CQQ = Gt_t - torch.einsum("nik,nlk->nil", Gti_iGi0, Gti)          # (70)
    CqQ = torch.einsum("ik,nlk->nil", c(params.G0iGi0), Gti)          # (71)
    dp0 = c(_center_minus(p0, params.hk.p0c, bc.base.pi))
    PIQ = c(state.p) + torch.einsum("nik,nk->ni", Gti_iGi0, dp0)      # (73)

    # eqn. 78: M = G0 + CQQ, projected to the non-zero subspace, scaled
    Mp = c(params.UtG0U)[None] + torch.einsum("ia,nij,jb->nab", Uc, CQQ,
                                               Uc)
    detM, iM_s = linalg.batched_det_inv(Mp / params.m_scale)
    iM = iM_s / params.m_scale                              # (n, r, r)

    # eqns. 79-84 with iM folded through U
    CqQU = CqQ @ Uc                                         # (n, d, r)
    G0U = c(params.G0U)                                     # (d, r)
    iM_CqQ = torch.einsum("nab,njb->naj", iM, CqQU)         # (n, r, d)
    Rqq = c(params.Cqq)[None] - torch.einsum("nia,naj->nij", CqQU,
                                             iM_CqQ)                   # (79)
    iM_G0 = torch.einsum("nab,jb->naj", iM, G0U)            # (n, r, d)
    RQQ = c(params.G0)[None] - torch.einsum("ia,naj->nij", G0U,
                                            iM_G0)                     # (80)
    RqQ = torch.einsum("nia,naj->nij", CqQU, iM_G0)                    # (81)

    dPIQ_U = (PIQ - c(p0)[None, :]) @ Uc                    # (n, r)
    iM_dPIQ = torch.einsum("nab,nb->na", iM, dPIQ_U)        # (n, r)
    Pq = c(bc.PIq) - torch.einsum("nia,na->ni", CqQU, iM_dPIQ)         # (82)
    PQ = c(p0)[None, :] + torch.einsum("ia,na->ni", G0U, iM_dPIQ)      # (83)
    gamma = c(bc.eps) - (0.5 / hbar**2) * torch.einsum("na,na->n", dPIQ_U,
                                                       iM_dPIQ)        # (84)
    return WMDerived(detA=detA, detM=detM, CQQ=CQQ, CqQ=CqQ, PIQ=PIQ,
                     Rqq=Rqq, RQQ=RQQ, RqQ=RqQ, Pq=Pq, PQ=PQ, gamma=gamma)


# ---------------------------------------------------------------------------
# scan fast path
# ---------------------------------------------------------------------------
#
# The time loop never needs the (n, d, d) tensors of eqns. 57-83: every
# observable of eqns. 85-100 is a scalar bilinear form x^T R y with x, y
# drawn from {q0-q(0), q0-q(t), n1(q), n1(Q), dPIQ}. Substituting the R
# definitions turns each form into (projected r-vector)^T iM (projected
# r-vector), and the projected vectors come from ONE per-step (n, 2r, r)
# solve Y = At^{-1} P.

def _wm_diag_core(params: WMParams, state: TrajState):
    """Per-mode 2x2 A/M algebra of the separable path: returns (detA,
    detM, y1, y2, iM) with every batched tensor (n, d); the plain chain of
    `ops.wm_diag`, which also builds the trackers on the card."""
    det_i, Mps, y1, y2, iM = _wm_diag_ops.wm_diag_core_plain(
        *state.Z.to(params.dtype), params.diag_pack)
    detA = linalg.logspace_mode_product(det_i.real, det_i.imag)
    detM = linalg.logspace_mode_product(Mps.real, Mps.imag)
    return detA, detM, y1, y2, iM


def wm_diag_inputs(params: WMParams, bc: WMBatchConstants, state: TrajState,
                   potential):
    """The ten (n, d) input planes of K5 for the current state — Mqq, Mqp,
    Mpq, Mpp, dQ = q0 - q(t), dp = p(t) - p0, dq = q0 - q(0), n1q, n1Q,
    v0c = [Gi+G0]^{-1} (p0 - pi) — at the pack's dtype (the differences
    taken at trajectory precision first), and n2Q (n,)."""
    t = params.dtype
    hk = params.hk
    dq, dQ = _displacements(params, bc, state)
    n1Q, n2Q = _nac_terms(potential, state.q)
    dp0 = _center_minus(hk.p0, hk.p0c, bc.base.pi).to(t)
    v0c = params.diag.ig0i[None, :] * dp0
    planes = (*state.Z.to(t), dQ.to(t), _dp_evolved(hk, state).to(t),
              dq.to(t), bc.n1q.to(t), n1Q.to(t), v0c)
    return tuple(x.contiguous() for x in planes), n2Q


def _wm_scan_derived_diag(params: WMParams, bc: WMBatchConstants,
                          state: TrajState, potential) -> WMScanDerived:
    """Per-mode 2x2 evaluation of `wm_scan_derived` (see WMDiagConsts):
    the same scalar forms as the generic path to rounding (the projection
    basis U is orthogonal and the balancing det-preserving). The whole
    time-dependent chain is one call of `ops.wm_diag.wm_diag_derived` —
    the fused kernel K5 on the card — over the (n, d) planes; the
    log-space mode products and the constant bilinear pieces follow."""
    cd = params.cdtype
    c = lambda x: x.to(cd)
    dg = params.diag
    inputs, n2Q = wm_diag_inputs(params, bc, state, potential)
    _, _, _, _, dQ, _, dq, n1q, _, _ = inputs
    scal, planes = _wm_diag_ops.wm_diag_derived(*inputs, params.diag_pack)
    detA = linalg.logspace_mode_product(planes[0], planes[1])
    detM = linalg.logspace_mode_product(planes[2], planes[3])
    gram = {pair: torch.complex(scal[:, 2 * i], scal[:, 2 * i + 1])
            for i, pair in enumerate(_wm_diag_ops.GRAM_PAIRS)}
    g_DD, g_Dn, p0_dQ, p0_n = (c(scal[:, _wm_diag_ops.scal_col(name)])
                               for name in ("g_DD", "g_Dn", "p0_dQ", "p0_n"))

    # constant-matrix bilinear pieces, diagonal weights
    cqq = dg.cqq[None, :]
    PIq = bc.PIq.to(params.dtype)
    c_dd = c(torch.sum(dq * cqq * dq, dim=1))
    c_dn = c(torch.sum(dq * cqq * n1q, dim=1))
    piq_dq = c(torch.sum(PIq * dq, dim=1))
    piq_n = c(torch.sum(PIq * n1q, dim=1))
    nacqQ = gram[1, 3]
    nacQ = (c(n2Q) + (g_Dn - gram[2, 3]) - gram[0, 3]
            - 1j * ((p0_n + gram[3, 4]) / hbar))
    nacq = (c(bc.n2q) + (c_dn - gram[0, 1]) - gram[1, 2]
            + 1j * ((piq_n - gram[1, 4]) / hbar))
    return WMScanDerived(
        detA=detA, detM=detM,
        gamma=bc.eps.to(params.dtype) - (0.5 / hbar**2) * gram[4, 4],
        rqq=c_dd - gram[0, 0], rQQ=g_DD - gram[2, 2], rqQ=gram[0, 2],
        Pq_dq=piq_dq - gram[0, 4], PQ_dQ=p0_dQ + gram[2, 4],
        kfac=nacqQ + nacQ * nacq)


def wm_scan_derived(params: WMParams, bc: WMBatchConstants, state: TrajState,
                    potential) -> WMScanDerived:
    """The scalar forms of eqns. 79-100 for the current state, through the
    projected, balanced A- and M-solves (no (n, d, d) tensors); on the
    separable path through the per-mode 2x2 chain. The algebra runs at the
    pack's dtype, the displacements at trajectory precision before their
    cast to it."""
    if params.scan_diag and state.diag_monodromy:
        return _wm_scan_derived_diag(params, bc, state, potential)
    cd, t = params.cdtype, params.dtype
    c = lambda x: x.to(cd)
    r = params.rank
    U = params.U
    st = dataclasses.replace(state, Z=state.Z.to(t))

    # balanced projections: U1/U2 carry D and 1/sqrt(s)
    X2 = _mono_proj(st.Mqp, params.U2)                      # (n, d, r)
    XL = torch.cat([_mono_proj(st.Mqq, params.U1), X2], dim=2)
    ZL = torch.cat([_mono_proj(st.Mpq, params.U1),
                    _mono_proj(st.Mpp, params.U2)], dim=2)  # (n, d, 2r)
    W = torch.einsum("ij,njb->nib", params.Gt, XL)          # (n, d, 2r)

    # Gram blocks of the TRANSPOSED balanced A-matrix:
    #   G  = [X1|X2]^T Gt [X1|X2],  B = [X1|X2]^T [Z1|Z2],  TR = [Z1|Z2]^T X2
    # its imaginary part is [[T11^T, 2 T21^T - T12], [T12^T, 2 T22^T - T22]]:
    # the left half is B's, the right half 2 B[:, :, r:] - TR
    G = c(torch.einsum("nia,nib->nab", XL, W))              # (n, 2r, 2r)
    B = torch.einsum("nia,nib->nab", XL, ZL)                # (n, 2r, 2r)
    TR = torch.einsum("nia,nib->nab", ZL, X2)               # (n, 2r, r)
    imag = torch.cat([B[:, :, :r], 2.0 * B[:, :, r:] - TR], dim=2)
    At = params.A_const_b.T[None] + G + 1j * (imag / hbar)  # (n, 2r, 2r)

    # P = BQUb^T U with BQUb = W + i ZL/hbar
    P = (c(torch.einsum("nia,ij->naj", W, U))
         + 1j * (torch.einsum("nia,ij->naj", ZL, U) / hbar))  # (n, 2r, r)

    # Y = At^{-1} P by block elimination of the 2x2-blocked At
    detA, Y = linalg.batched_det_solve_blocks(
        At[:, :r, :r], At[:, :r, r:], At[:, r:, :r], At[:, r:, r:],
        P[:, :r], P[:, r:])                                 # (n, 2r, r)

    # M' = M0 - Y^T (P + C2b Y)  (eqns. 68, 78)
    C2Y = torch.einsum("ab,nbk->nak", params.C2b, Y)
    Mp = c(params.M0)[None] - torch.einsum("nak,nal->nkl", Y, P + C2Y)

    # projected observable vectors (differences at trajectory precision)
    hk = params.hk
    dq, dQ = (x.to(t) for x in _displacements(params, bc, state))
    n1q = bc.n1q.to(t)
    n1Q, n2Q = _nac_terms(potential, state.q)
    n1Q = n1Q.to(t)
    p0 = hk.p0.to(t)

    def A_vec(x):
        # CqQU^T x = Y^T (Fq^T x)
        z = torch.einsum("ia,ni->na", params.Fq, c(x))      # (n, 2r)
        return torch.einsum("nak,na->nk", Y, z)             # (n, r)

    dPIQ_U = (c(_dp_evolved(hk, state).to(t) @ U)
              + torch.einsum("nak,na->nk", Y, bc.z0))       # (n, r)
    stack = torch.stack([A_vec(dq), A_vec(n1q), c(dQ @ params.G0U),
                         c(n1Q @ params.G0U), dPIQ_U], dim=2)  # (n, r, 5)
    # one det + solve applies iM to the whole 5-vector stack
    detM, Z5 = linalg.batched_det_solve(Mp / params.m_scale, stack)
    gram = torch.einsum("nak,nal->nkl", stack, Z5 / params.m_scale)

    # constant-matrix bilinear pieces
    quad = lambda x, M, y: c(torch.einsum("ni,ij,nj->n", x, M, y))
    dot = lambda x, y: c(torch.sum(x * y, dim=-1))
    PIq = bc.PIq.to(t)
    c_dd = quad(dq, params.Cqq, dq)
    c_dn = quad(dq, params.Cqq, n1q)
    g_DD = quad(dQ, params.G0, dQ)
    g_Dn = quad(dQ, params.G0, n1Q)
    piq_dq = dot(PIq, dq)
    piq_n = dot(PIq, n1q)
    p0_dQ = dot(p0[None, :], dQ)
    p0_n = dot(p0[None, :], n1Q)

    # IC-correlation NAC factors (eqns. 89-100, cf. wm_observables)
    nacqQ = gram[:, 1, 3]                                   # n1q^T RqQ n1Q
    nacQ = (c(n2Q)
            + (g_Dn - gram[:, 2, 3])                        # dQ^T RQQ n1Q
            - gram[:, 0, 3]                                 # dq^T RqQ n1Q
            - 1j * ((p0_n + gram[:, 3, 4]) / hbar))         # PQ . n1Q
    nacq = (c(bc.n2q)
            + (c_dn - gram[:, 0, 1])                        # dq^T Rqq n1q
            - gram[:, 1, 2]                                 # n1q^T RqQ dQ
            + 1j * ((piq_n - gram[:, 1, 4]) / hbar))        # Pq . n1q
    return WMScanDerived(
        detA=detA, detM=detM,
        gamma=bc.eps.to(t) - (0.5 / hbar**2) * gram[:, 4, 4],
        rqq=c_dd - gram[:, 0, 0], rQQ=g_DD - gram[:, 2, 2],
        rqQ=gram[:, 0, 2], Pq_dq=piq_dq - gram[:, 0, 4],
        PQ_dQ=p0_dQ + gram[:, 2, 4], kfac=nacqQ + nacQ * nacq)


def _prefactor(params, state, c_signed, detA, detM, signs_A, signs_M):
    """auto_pref C e^{iS/hbar} / sqrt(detA) / sqrt(detM), sign-tracked, at
    C's complex dtype (the phase of S reduced before any down-cast)."""
    return (params.auto_pref * c_signed
            * linalg.phase_exp(state.S / hbar, c_signed.dtype)
            * signs_A / torch.sqrt(detA) * signs_M / torch.sqrt(detM))


def wm_scan_observables_qp(params: WMParams, bc: WMBatchConstants,
                           state: TrajState, sd: WMScanDerived, c_signed,
                           signs_A, signs_M):
    """The per-trajectory contributions (cauto_qp, kic_qp) of eqns. 85,
    89-100 from the scalar forms, complex (n,) each."""
    expo = (sd.gamma + bc.base.logw_norm.to(params.dtype)
            - 0.5 * sd.rqq - 0.5 * sd.rQQ + sd.rqQ
            + 1j * ((sd.PQ_dQ - sd.Pq_dq) / hbar))
    cauto_qp = _prefactor(params, state, c_signed, sd.detA, sd.detM,
                          signs_A, signs_M) * torch.exp(expo)
    return cauto_qp, (1.0 / hbar**2) * sd.kfac * cauto_qp


def wm_scan_observables(params: WMParams, bc: WMBatchConstants,
                        state: TrajState, sd: WMScanDerived, c_signed,
                        signs_A, signs_M):
    """(C_auto(t), k~ic(t)) batch sums from the scalar forms (eqns. 85,
    89-100) as 0-d device tensors, without the weight scale and the
    excited-state phase (both applied on the host)."""
    cauto_qp, kic_qp = wm_scan_observables_qp(params, bc, state, sd,
                                              c_signed, signs_A, signs_M)
    return torch.sum(cauto_qp), torch.sum(kic_qp)


# ---------------------------------------------------------------------------
# full-tensor observables (the oracle of the fast path)
# ---------------------------------------------------------------------------

def _bilinear(x, R, y):
    return torch.einsum("ni,nij,nj->n", x, R, y)


def wm_autocorr_qp(params: WMParams, bc: WMBatchConstants, state: TrajState,
                   derived: WMDerived, c_signed, signs_A, signs_M):
    """Per-trajectory autocorrelation contribution (eqn. 85). The
    normalised MC log-weight is folded into the exponent."""
    cd = params.cdtype
    dq, dQ = (x.to(cd) for x in _displacements(params, bc, state))
    expo = (derived.gamma + bc.base.logw_norm.to(cd)
            - 0.5 * _bilinear(dq, derived.Rqq, dq)
            - 0.5 * _bilinear(dQ, derived.RQQ, dQ)
            + _bilinear(dq, derived.RqQ, dQ)
            + 1j * ((torch.sum(derived.PQ * dQ, dim=1)
                     - torch.sum(derived.Pq * dq, dim=1)) / hbar))
    return _prefactor(params, state, c_signed, derived.detA, derived.detM,
                      signs_A, signs_M) * torch.exp(expo)


def wm_observables(params: WMParams, bc: WMBatchConstants, state: TrajState,
                   derived: WMDerived, c_signed, signs_A, signs_M,
                   potential):
    """(C_auto(t), k~ic(t)) batch sums from the full tensors (eqns. 85,
    89-100)."""
    cd = params.cdtype
    cauto_qp = wm_autocorr_qp(params, bc, state, derived, c_signed, signs_A,
                              signs_M)
    n1Q, n2Q = _nac_terms(potential, state.q)
    n1q, n1Q = bc.n1q.to(cd), n1Q.to(cd)
    dq, dQ = (x.to(cd) for x in _displacements(params, bc, state))
    nacqQ = _bilinear(n1q, derived.RqQ, n1Q)
    nacQ = (n2Q.to(cd) + _bilinear(dQ, derived.RQQ, n1Q)
            - _bilinear(dq, derived.RqQ, n1Q)
            - 1j * (torch.sum(derived.PQ * n1Q, dim=1) / hbar))
    # the cross term pairs (q0 - Q) with the second index of RqQ
    nacq = (bc.n2q.to(cd) + _bilinear(dq, derived.Rqq, n1q)
            - _bilinear(n1q, derived.RqQ, dQ)
            + 1j * (torch.sum(derived.Pq * n1q, dim=1) / hbar))
    kic_qp = (1.0 / hbar**2) * (nacqQ + nacQ * nacq) * cauto_qp
    return torch.sum(cauto_qp), torch.sum(kic_qp)


# ---------------------------------------------------------------------------
# coefficients, wavefunction and norm
# ---------------------------------------------------------------------------

def wm_coefficients(params: WMParams, bc: WMBatchConstants, state: TrajState,
                    derived: WMDerived, c_signed, signs_A):
    """Gaussian expansion coefficients (eqn. 75), without the weight scale.
    The pi / 2 pi factors are absorbed in the pseudo-determinants; the
    1/(2 pi)^d of eqn. 75 is the (2 pi hbar)^d of the Monte-Carlo weight."""
    cd = params.cdtype
    dq = _center_minus(params.hk.q0, params.hk.q0c, bc.base.qi).to(cd)
    phase = linalg.phase_exp(state.S / hbar, cd)
    v = (params.coef_pref * c_signed * phase * signs_A
         / torch.sqrt(derived.detA) * torch.exp(bc.eps.to(cd)))
    v = v * torch.exp(-0.5 * torch.einsum("ni,ij,nj->n", dq,
                                          params.Cqq.to(cd), dq)
                      - 1j * (torch.sum(bc.PIq.to(cd) * dq, dim=1) / hbar))
    return v * bc.base.weight


def wm_log_coefficients(params: WMParams, bc: WMBatchConstants,
                        state: TrajState, derived: WMDerived, c_signed,
                        signs_A):
    """log v_i of the coefficients (eqn. 75) as two float64 tensors
    (log |v_i|, arg v_i, the phase unwrapped additively): the range-safe
    form, weight and weight scale included, so exp(log v) is the fully
    weighted coefficient. The quadratic forms run at the pack's dtype, the
    sum at float64."""
    f64, t = torch.float64, params.dtype
    dq = _center_minus(params.hk.q0, params.hk.q0c, bc.base.qi).to(t)
    quad = 0.5 * torch.einsum("ni,ij,nj->n", dq, params.Cqq, dq)
    phase_pi = torch.sum(bc.PIq.to(t) * dq, dim=1) / hbar
    log_re = (params.log_coef_pref + torch.log(torch.abs(c_signed)).to(f64)
              - 0.5 * torch.log(torch.abs(derived.detA)).to(f64)
              + bc.eps.to(f64) + bc.base.logw_norm.to(f64)
              + bc.base.log_weight_scale - quad.to(f64))
    log_im = (torch.angle(c_signed).to(f64) + state.S.to(f64) / hbar
              - 0.5 * torch.angle(derived.detA).to(f64)
              + 0.5 * math.pi * (1.0 - signs_A.to(f64))
              - phase_pi.to(f64))
    return log_re, log_im


def wm_wavefunction(params: WMParams, bc: WMBatchConstants,
                    state: TrajState, derived: WMDerived, log_v, x):
    """psi(x, t) on a grid x (nx, d) (eqn. 75) from log-coefficients: each
    trajectory's log |v| joins its Gaussian exponent and the trajectory
    sum is exponent-shifted. Returns (psi_shifted (nx,), zmax (nx,)):
    psi = psi_shifted * exp(zmax), recombined by the caller on the host."""
    log_re, log_im = log_v
    cd, rd = params.cdtype, params.dtype
    dxQ = x.to(cd)[None, :, :] - state.q.to(cd)[:, None, :]  # (n, nx, d)
    dq = _center_minus(params.hk.q0, params.hk.q0c, bc.base.qi).to(cd)
    expo = (-0.5 * torch.einsum("nxi,nij,nxj->nx", dxQ, derived.CQQ, dxQ)
            + torch.einsum("ni,nij,nxj->nx", dq, derived.CqQ, dxQ)
            + 1j * (torch.einsum("ni,nxi->nx", derived.PIQ, dxQ) / hbar))
    Zre = log_re.to(rd)[:, None] + expo.real
    Zim = log_im.to(rd)[:, None] + expo.imag
    zmax = torch.max(Zre, dim=0).values
    return torch.sum(linalg.complex_exp(Zre - zmax[None, :], Zim, cd),
                     dim=0), zmax


def wm_pair_bytes(dim, rank):
    """Bytes of intermediates per pair of the WM norm's block term: the
    (r, r) pair matrix, its scaled copy, inverse and product (complex), the
    (d,)-vectors of the pair exponent, with room to spare."""
    return 16 * (6 * rank * rank + 8 * dim)


def _wm_norm_block_term(pack, Qi, di, Ci, UCi, CUi, dUi, lri, lii,
                        Qj, dj, Cj, UCj, CUj, dUj, lrj, lij):
    """One (bi, bj) block pair of the WM pair sum (ordered grid).

    Per trajectory: Q = q(t), d = CqQ^T (q0 - q(0)) + i PIQ / hbar, C = CQQ
    (d, d), UC = U^T CQQ (r, d), CU = U^T CQQ U (r, r), dU = d U, and the
    log-coefficients. The pair matrix D_ij = conj(CQQ_i) + CQQ_j is formed
    in the projected space (U is real, so U^T D_ij U = conj(CU_i) + CU_j),
    scaled by m_scale and inverted with `det_inv` (K3 on the card)."""
    m_scale, m_log_det, det_inv = pack
    dQ = (Qj[None, :, :] - Qi[:, None, :]).to(CUi.dtype)       # (bi, bj, d)
    detD, iD_s = det_inv((CUi.conj()[:, None] + CUj[None, :]) / m_scale)
    iD = iD_s / m_scale                                       # (bi, bj, r, r)
    bU = (torch.einsum("nab,mnb->mna", UCj, dQ)
          + dUi.conj()[:, None, :] + dUj[None, :, :])         # (bi, bj, r)
    pair_expo = (-0.5 * torch.einsum("mna,nab,mnb->mn", dQ, Cj, dQ)
                 - torch.einsum("na,mna->mn", dj, dQ)
                 + 0.5 * torch.einsum("mna,mnab,mnb->mn", bU, iD, bU))
    total_re = (lri[:, None] + lrj[None, :] + pair_expo.real
                - 0.5 * (torch.log(torch.abs(detD)) + m_log_det))
    total_im = (-lii[:, None] + lij[None, :] + pair_expo.imag
                - 0.5 * torch.angle(detD))
    return torch.sum(linalg.complex_exp(total_re, total_im, CUi.dtype))


def wm_norm_arrays(params: WMParams, bc: WMBatchConstants, state: TrajState,
                   derived: WMDerived, log_v, det_inv=None):
    """(pack, arrays) of the WM pair sum (see `_wm_norm_block_term`);
    `det_inv` defaults to `linalg.batched_det_inv` (K3 on the card; a
    check can hand it the plain version instead). Everything per
    trajectory is at the pack's dtype, the log-coefficients included."""
    cd, rd = params.cdtype, params.dtype
    U = params.U.to(cd)
    dq0i = _center_minus(params.hk.q0, params.hk.q0c, bc.base.qi).to(cd)
    dvec = (torch.einsum("nji,nj->ni", derived.CqQ, dq0i)
            + 1j * (derived.PIQ / hbar))                      # (n, d)
    UC = torch.einsum("ia,nij->naj", U, derived.CQQ)          # (n, r, d)
    pack = (params.m_scale, params.m_log_det,
            det_inv or linalg.batched_det_inv)
    return pack, (state.q.to(rd), dvec, derived.CQQ, UC, UC @ U, dvec @ U,
                  *(x.to(rd) for x in log_v))


def wm_norm(params: WMParams, bc: WMBatchConstants, state: TrajState,
            derived: WMDerived, log_v, block=None, sample_pairs=None, key=0,
            group=None):
    """|psi| of the WM wavefunction: O(n^2) with an r x r inverse per
    pair, each entry of the pair sum assembled as ONE exponent (log v_m^*
    + log v_n + the pair-overlap exponent - 1/2 Log det), over the full
    ordered block-pair grid (the pair exponent is not assembled
    symmetrically); under a process `group` (the arguments this rank's
    rows) by the ring over the same ordered pairs (`hk._pair_sum_ring`),
    with K3 on every block pair of every rotation. `block` defaults to
    `pair_block` at `wm_pair_bytes`; with `sample_pairs` (a single process
    only) the subsampled estimate (norm, stderr)."""
    _no_sampled_ring(sample_pairs, group)
    pack, arrays = wm_norm_arrays(params, bc, state, derived, log_v)
    n = state.q.shape[0]
    if block is None:
        block = pair_block(n, wm_pair_bytes(params.dim, params.rank),
                           state.q.device)
    if sample_pairs is not None:
        return _sqrt_norm(*subsampled_pair_sum(
            _wm_norm_block_term, pack, arrays, _divisor_block(n, block),
            sample_pairs=sample_pairs, key=key, hermitian=False))
    return _sqrt_norm(_pair_sum(_wm_norm_block_term, pack, arrays, block,
                                group, hermitian=False))


# ---------------------------------------------------------------------------
# stateful propagator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WMTrackers:
    """The three branch-cut trackers of WM: sqrt of the HK prefactor C^2,
    of detA and of detM."""

    prefactorC: SignTracker
    detA: SignTracker
    detM: SignTracker


class WaltonManolopoulosPropagator(HermanKlukPropagator):
    """WM propagation of one trajectory batch on one device: the HK
    propagator's sampling, time loop and host reduction, with the WM
    parameter pack, batch constants, trackers and per-step observables.

    Parameters
    ----------
    Gamma_i, Gamma_t : (d, d) width matrices of the frozen Gaussians
    alpha, beta : float > 0
        Filinov cell parameters; larger values make the linearisation more
        accurate but need more trajectories.
    device : torch device of the propagation
    integrator : "rk4" or "exact", as for HermanKlukPropagator
    dtype, traj_dtype : the precision mode, as for HermanKlukPropagator
    """

    def __init__(self, Gamma_i, Gamma_t, alpha, beta, device,
                 integrator="rk4", dtype=torch.float64, traj_dtype=None):
        super().__init__(Gamma_i, Gamma_t, device, integrator=integrator,
                         dtype=dtype, traj_dtype=traj_dtype)
        self.alpha = float(alpha)
        self.beta = float(beta)

    def _make_params(self, Gamma_0, q0, p0, sampling):
        return _build_wm_params(
            super()._make_params(Gamma_0, q0, p0, sampling), self.Gamma_i,
            self.Gamma_t, Gamma_0, sampling.U, sampling.iGi0, self.alpha,
            self.beta, self.device, self.dtype)

    def _make_batch_constants(self, qi, pi, log_prob, potential):
        return wm_batch_constants(self.params, qi, pi, log_prob, potential,
                                  self.group)

    def _make_trackers(self, state):
        if self.params.scan_diag and state.diag_monodromy:
            # per-mode core only: the full-tensor wm_derived would form
            # (n, d, d) complex tensors
            detA, detM, _, _, _ = _wm_diag_core(self.params, state)
        else:
            derived = wm_derived(self.params, self.bc, state)
            detA, detM = derived.detA, derived.detM
        return WMTrackers(
            prefactorC=SignTracker.fresh(hk_prefactor_det(self.params.hk,
                                                          state)),
            detA=SignTracker.fresh(detA), detM=SignTracker.fresh(detM))

    def _loop_constants(self, bc):
        """The batch constants as the time loop's blocks read them (see
        `HermanKlukPropagator._loop_constants`)."""
        return dataclasses.replace(
            bc, base=_only(bc.base, ("qi", "pi", "logw_norm")))

    def _loop_params(self):
        return dataclasses.replace(self.params,
                                   hk=_device_facs(self.params.hk))

    @staticmethod
    def _observe(params, state, tracker, potential, bc, m2_mode=False):
        prefactorC = tracker.prefactorC.update(
            hk_prefactor_det(params.hk, state))
        sd = wm_scan_derived(params, bc, state, potential)
        detA = tracker.detA.update(sd.detA)
        detM = tracker.detM.update(sd.detM)
        cauto_qp, kic_qp = wm_scan_observables_qp(
            params, bc, state, sd, prefactorC.sqrt(), detA.signs,
            detM.signs)
        return (WMTrackers(prefactorC, detA, detM), torch.sum(cauto_qp),
                torch.sum(kic_qp), *_moments(cauto_qp, kic_qp, m2_mode))

    # -- granular API ---------------------------------------------------------

    def semiclassical_prefactor(self):
        prefactorC = self.tracker.prefactorC.update(
            hk_prefactor_det(self.params.hk, self.state))
        self.tracker = dataclasses.replace(self.tracker,
                                           prefactorC=prefactorC)
        return prefactorC.sqrt()

    def initial_positions_and_momenta(self):
        return self.bc.base.qi, self.bc.base.pi

    def _sync_derived(self):
        """The full tensors of `wm_derived` at the current state (K3 on
        the A- and M-matrices), with the detA / detM trackers advanced to
        it (dense and diagonal states alike)."""
        derived = wm_derived(self.params, self.bc, self.state)
        self.tracker = dataclasses.replace(
            self.tracker, detA=self.tracker.detA.update(derived.detA),
            detM=self.tracker.detM.update(derived.detM))
        return derived

    def autocorrelation(self, energy0_es=0.0):
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        cauto = torch.sum(wm_autocorr_qp(
            self.params, self.bc, self.state, derived, c,
            self.tracker.detA.signs, self.tracker.detM.signs))
        return (self._batch_sum(cauto) * self.bc.weight_scale
                * self._phase(energy0_es))

    def ic_correlation(self, potential, energy0_es=0.0):
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        _, kic = wm_observables(self.params, self.bc, self.state, derived, c,
                                self.tracker.detA.signs,
                                self.tracker.detM.signs, potential)
        return (self._batch_sum(kic) * self.bc.weight_scale
                * self._phase(energy0_es))

    def coefficients(self):
        """Linear-scale coefficients; they underflow where the true
        magnitude does — use `log_coefficients` at high mode counts."""
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        v = wm_coefficients(self.params, self.bc, self.state, derived, c,
                            self.tracker.detA.signs)
        return v * self.bc.weight_scale

    def _log_coefficients_and_derived(self):
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        return wm_log_coefficients(self.params, self.bc, self.state, derived,
                                   c, self.tracker.detA.signs), derived

    def _log_coefficients(self):
        return self._log_coefficients_and_derived()[0]

    def wavefunction(self, x):
        log_v, derived = self._log_coefficients_and_derived()
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)
        return self._batch_grid(*wm_wavefunction(
            self.params, self.bc, self.state, derived, log_v, x))

    def norm(self, sample_pairs=None, key=0, block=None):
        """|psi| (O(n^2) with K3 on every block pair's (bi bj, r, r) pair
        matrices); see `wm_norm`."""
        log_v, derived = self._log_coefficients_and_derived()
        return wm_norm(self.params, self.bc, self.state, derived, log_v,
                       block=block, sample_pairs=sample_pairs, key=key,
                       group=self.group)
