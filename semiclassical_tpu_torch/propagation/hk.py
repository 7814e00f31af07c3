# coding: utf-8
"""Herman-Kluk (HK) semiclassical IVR propagator.

[HK] E. Kluk, M. Herman, H. Davis, J. Chem. Phys. 84, 326 (1986)

The port of `semiclassical_tpu.propagation.hk` on two paths:

* the dense-prefactor path (molecular harmonic and sGDML PES, any width
  matrix): `HKParams` / `BatchConstants` are precomputed once: the
  null-space projector U of singular width matrices is folded into the
  constant left and right factors of the prefactor matrix, so the
  per-step work is two real matmuls over the stacked monodromy plus one
  batched (n, r, r) complex determinant — on the card the CUDA kernel that
  `linalg.batched_det` picks by r (K1 in `ops.det`, K4 in `ops.det_block`);
* the separable path (model potentials, diagonal Hessians and diagonal
  widths): the monodromy is kept in the diagonal representation, the
  prefactor matrix is diagonal and its determinant a log-space product
  over modes, and the overlap exponents and NAC forms are elementwise —
  no matmul and no determinant kernel in the step;
* everything that depends only on the initial phase-space points (the
  overlap <qi,pi|phi(0)>, the Monte-Carlo log-weights, the initial-point
  NAC factor of k~ic) is computed once per batch;
* `propagate` runs the time loop in scan segments of `chunk` steps (a
  `taylor_every` window of an sGDML potential restarts at each, as in the
  JAX package), each in blocks of steps that the card runs as replays of
  captured CUDA graphs (`graph`, the counterpart of the JAX package's
  jitted scans and of their cache: the process keeps one loop per card
  across batches, propagators and sub-batches of the same key; eager on
  the CPU and under `graph.eager()`), with every per-step result written
  into preallocated device tensors — no host synchronisation per step. C(t),
  k~ic(t) and the batch-mean energies come to the host once per call,
  where the energy-conservation guard and the separable phases apply.
  With `error_bars` every step also writes the second moments
  sum_i |x_i|^2 of both per-trajectory contribution vectors, which become
  the per-step Monte-Carlo standard errors on the host; with
  `micro_batch` every segment runs sub-batch by sub-batch and the sums
  and moments add up (the JAX package's `_micro_scan`);
* `integrator="exact"` replaces RK4 by a map with no time-discretization
  error: the affine map of a constant-Hessian PES (`exact_harmonic`) or
  the closed-form Morse map with its RK4 side-channel (`exact_morse`),
  whose constants and phase persist across segments and calls until dt,
  the potential object or the state itself is replaced; both run at the
  state's dtypes in every precision mode (the Morse map's float64
  constants split hi/lo on float32 trajectories);
* the granular API (`semiclassical_prefactor`, `autocorrelation`,
  `coefficients`, `norm`, `wavefunction`, ...) works on the current state;
  the O(n^2) norm is a loop over block pairs on the device with one host
  read (`blocked_pair_sum`, `subsampled_pair_sum`), its block size chosen
  from a memory budget (`pair_block`);
* the precision modes of the JAX package: `dtype` is the precision of the
  parameter packs, the monodromy and every complex quantity (float32 /
  complex64 in the reduced modes, so K1-K4 run at complex64), and
  `traj_dtype` that of q, p and S (float64 under "mixed", float32 under
  "f32", or "comp32": float32 q and p with float32 Neumaier residuals and
  a float64 S). The displacements of the observables are taken at the
  trajectory precision (the comp32 residuals folded in) before their
  quadratic forms run at `dtype`.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.coherent import (OverlapParams,
                                              WavefunctionParams,
                                              overlap_exponent_displaced,
                                              overlap_exponent_matrix,
                                              overlap_exponent_vector,
                                              overlap_matrix, overlap_vector,
                                              wavefunction_log)
from semiclassical_tpu_torch.potentials.base import (ConstHessian,
                                                     DenseHessian,
                                                     DiagHessian)
from semiclassical_tpu_torch.parallel.group import (group_sum,
                                                    pad_to_multiple,
                                                    ring_shift, shard_rows,
                                                    world_of)
from semiclassical_tpu_torch.propagation import graph
from semiclassical_tpu_torch.propagation.eom import (const_step_map,
                                                     make_taylor_window,
                                                     rk4_step)
from semiclassical_tpu_torch.propagation.exact_harmonic import (
    build_harmonic_map, harmonic_step, supports_exact_harmonic)
from semiclassical_tpu_torch.propagation.exact_morse import (
    MorseMapCarry, MorseMapPack, build_morse_map, morse_map_advance,
    morse_map_state, supports_exact_morse)
from semiclassical_tpu_torch.propagation.state import SignTracker, TrajState
from semiclassical_tpu_torch.sampling import (SamplingParams,
                                              log_sampling_statistics,
                                              sample_initial_conditions,
                                              standard_normals)
from semiclassical_tpu_torch.units import hbar

logger = logging.getLogger(__name__)

__all__ = [
    "HKParams",
    "BatchConstants",
    "HermanKlukPropagator",
    "build_hk_params",
    "hk_prefactor_mat",
    "hk_prefactor_det",
    "hk_batch_constants",
    "hk_observables",
    "hk_observables_qp",
    "second_moment",
    "hk_coefficients",
    "hk_log_coefficients",
    "pair_block",
    "blocked_pair_sum",
    "subsampled_pair_sum",
    "pairwise_norm",
    "pairwise_norm_log",
    "check_energy_conservation",
]


@dataclass(frozen=True)
class HKParams:
    """Constant parameter pack of the HK propagator.

    Prefactor (eqn. 29 of the original HK code):

        C^2 = det( U^T [ 1/2 ( Gt^{1/2} Mqq Gi^{-1/2} + Gt^{-1/2} Mpp Gi^{1/2}
                   - i hbar Gt^{1/2} Mqp Gi^{1/2}
                   + i/hbar Gt^{-1/2} Mpq Gi^{-1/2} ) ] U )

    with U the basis of the non-zero subspace of Gamma_i + Gamma_0, and the
    factors Lt_s = U^T Gt^{1/2}, Lt_i = U^T Gt^{-1/2}, Ri_s = Gi^{1/2} U,
    Ri_i = Gi^{-1/2} U. They are stored packed for the stacked monodromy
    Z = [[Mqq, Mqp], [Mpq, Mpp]] (see `hk_prefactor_mat`):

    left  (4r, 2d) real: [Re; Im] of the row-interleaved left factor whose
          row 2a is [Lt_s[a], 0] and row 2a+1 is [0, Lt_i[a]];
    right (4d, 2r) real: [Re | Im] of 1/2 [Ri_i; -i hbar Ri_s;
          i/hbar Ri_i; Ri_s].
    """

    left: torch.Tensor
    right: torch.Tensor
    q0: torch.Tensor      # (d,)
    p0: torch.Tensor      # (d,)
    R: torch.Tensor       # (d, d)  Gamma_0 [Gi+G0]^{-1} Gamma_i (NAC factor)
    shift: torch.Tensor   # (d, d)  (Gamma_0 [Gi+G0]^{-1})^T
    csoi0: OverlapParams  # <.,Gi | .,G0>
    csot0: OverlapParams  # <.,Gt | .,G0>
    dim: int
    rank: int
    # separable path (`factors_diag`: real factors whose Lt_x Ri_y products
    # are all diagonal — diagonal widths, up to the mode permutation in U —
    # so the prefactor matrix of a diagonal monodromy is diagonal):
    # diag_K (4, d, r) holds K = Lt * Ri^T for the pairs (Lt_s, Ri_i),
    # (Lt_s, Ri_s), (Lt_i, Ri_s), (Lt_i, Ri_i), and mat_aa = (m @ K)_a;
    # at full rank, when all four share one permutation, diag_k (4, d)
    # holds their nonzero entries in unpermuted mode order (the mode
    # product is permutation-invariant). None where they do not apply.
    diag_K: torch.Tensor | None = None
    diag_k: torch.Tensor | None = None
    R_diag: torch.Tensor | None = None      # (d,) diagonal of R, if diagonal
    shift_diag: torch.Tensor | None = None  # (d,) diagonal of shift, ditto
    # the norm and the grid wavefunction
    csott: OverlapParams | None = None      # <.,Gt | .,Gt>
    wf: WavefunctionParams | None = None    # Gamma_t
    # comp32: the float32 residuals of q0 and p0 (true center q0 + q0c)
    q0c: torch.Tensor | None = None
    p0c: torch.Tensor | None = None

    @property
    def factors_diag(self):
        return self.diag_K is not None

    @property
    def dtype(self):
        """The real dtype of the packs and the monodromy algebra."""
        return self.left.dtype

    @property
    def cdtype(self):
        """The complex dtype of the prefactor and the observables."""
        return linalg.complex_dtype(self.left.dtype)

    @staticmethod
    def from_factors(Lt_s, Lt_i, Ri_s, Ri_i, q0, p0, G0, iGi0, R,
                     csoi0, csot0, device, diag=None, csott=None, wf=None,
                     dtype=torch.float64, traj_dtype=None, q0c=None,
                     p0c=None):
        """Pack the complex factors (host numpy) for the device: the
        factors and the NAC constants (R, shift and their diagonals) at
        `dtype`, the center q0, p0 at `traj_dtype` (default `dtype`), the
        comp32 residuals q0c, p0c at float32. The separable-path fields
        diag_k, R_diag and shift_diag are derived here unless given (as
        the dict `diag`)."""
        Lt_s, Lt_i = np.asarray(Lt_s), np.asarray(Lt_i)      # (r, d)
        Ri_s, Ri_i = np.asarray(Ri_s), np.asarray(Ri_i)      # (d, r)
        r, d = Lt_s.shape
        lint = np.zeros((2 * r, 2 * d), dtype=np.complex128)
        lint[0::2, :d] = Lt_s
        lint[1::2, d:] = Lt_i
        rst = 0.5 * np.concatenate([Ri_i, -1j * hbar * Ri_s,
                                    (1j / hbar) * Ri_i, Ri_s], axis=0)
        traj_dtype = dtype if traj_dtype is None else traj_dtype
        t = lambda x, dt=dtype: None if x is None else torch.tensor(
            np.asarray(x, dtype=np.float64), device=device, dtype=dt)
        g = lambda x: t(x, traj_dtype)
        G0 = np.asarray(G0, dtype=np.float64)
        iGi0 = np.asarray(iGi0, dtype=np.float64)
        shift = (G0 @ iGi0).T
        diag_K, diag_k = _diag_factors(Lt_s, Lt_i, Ri_s, Ri_i)
        if diag is None:
            diag = {"diag_k": diag_k}
            for name, M in (("R_diag", np.asarray(R)), ("shift_diag", shift)):
                diag[name] = np.diag(M) if _is_diag(M) else None
        return HKParams(
            left=t(np.concatenate([lint.real, lint.imag], axis=0)),
            right=t(np.concatenate([rst.real, rst.imag], axis=1)),
            q0=g(q0), p0=g(p0), R=t(R), shift=t(shift),
            csoi0=csoi0, csot0=csot0, dim=int(d), rank=int(r),
            diag_K=t(diag_K), diag_k=t(diag["diag_k"]),
            R_diag=t(diag["R_diag"]), shift_diag=t(diag["shift_diag"]),
            csott=csott, wf=wf, q0c=t(q0c, torch.float32),
            p0c=t(p0c, torch.float32))


def _is_diag(M):
    """Exact-zero off-diagonals, as the JAX package tests them."""
    return float(np.abs(M - np.diag(np.diag(M))).max()) == 0.0


def _diag_factors(Lt_s, Lt_i, Ri_s, Ri_i):
    """(diag_K, diag_k) of the separable path (see HKParams), or None for
    what does not apply."""
    pairs = ((Lt_s, Ri_i), (Lt_s, Ri_s), (Lt_i, Ri_s), (Lt_i, Ri_i))
    if any(float(np.abs(np.imag(m)).max()) != 0.0
           for m in (Lt_s, Lt_i, Ri_s, Ri_i)):
        return None, None
    if not all(_is_diag(np.abs(L.real) @ np.abs(R.real)) for L, R in pairs):
        return None, None
    K = np.stack([(L.real * R.real.T).T for L, R in pairs])  # (4, d, r)
    if K.shape[1] != K.shape[2]:
        return K, None
    d = K.shape[1]
    perms = [np.argmax(np.abs(k), axis=1) for k in K]
    if not all((perm == perms[0]).all() for perm in perms[1:]):
        return K, None
    return K, np.stack([k[np.arange(d), perm] for k, perm in zip(K, perms)])


def _residual32(x):
    """The float32 residual of a float64 array: x - float32(x)."""
    x = np.asarray(x, dtype=np.float64)
    return x - x.astype(np.float32).astype(np.float64)


def build_hk_params(Gamma_i, Gamma_t, Gamma_0, q0, p0, U, iGi0, device,
                    dtype=torch.float64, traj_dtype=None):
    """HKParams from the width matrices, the wavepacket center and the
    sampling subspace U (d, r) / pseudo-inverse iGi0 (host numpy).

    `dtype` is the precision of the factors, the overlap exponents and
    every complex output; `traj_dtype` (default `dtype`) that of the
    center q0, p0, which enters differences with the trajectory state, or
    "comp32": a float32 center with its float32 residuals q0c, p0c."""
    compensated = traj_dtype == "comp32"
    if compensated:
        traj_dtype = torch.float32
    Gamma_i = np.asarray(Gamma_i, dtype=np.float64)
    Gamma_t = np.asarray(Gamma_t, dtype=np.float64)
    Gamma_0 = np.asarray(Gamma_0, dtype=np.float64)
    sqGi, isqGi = linalg.sym_sqrtm(Gamma_i)
    sqGt, isqGt = linalg.sym_sqrtm(Gamma_t)
    Uc = np.asarray(U).astype(np.complex128)
    return HKParams.from_factors(
        Lt_s=Uc.T @ sqGt, Lt_i=Uc.T @ isqGt, Ri_s=sqGi @ Uc,
        Ri_i=isqGi @ Uc, q0=q0, p0=p0, G0=Gamma_0, iGi0=iGi0,
        R=Gamma_0 @ iGi0 @ Gamma_i,
        csoi0=OverlapParams.create(Gamma_i, Gamma_0, device, dtype),
        csot0=OverlapParams.create(Gamma_t, Gamma_0, device, dtype),
        device=device,
        csott=OverlapParams.create(Gamma_t, Gamma_t, device, dtype),
        wf=WavefunctionParams.create(Gamma_t, device, dtype),
        dtype=dtype, traj_dtype=traj_dtype,
        q0c=_residual32(q0) if compensated else None,
        p0c=_residual32(p0) if compensated else None)


@dataclass(frozen=True)
class BatchConstants:
    """Per-batch constants: initial conditions and precomputed observables.

    The Monte-Carlo weights 1/(n P(qi,pi) (2 pi hbar)^d) span hundreds of
    orders of magnitude across the batch in many dimensions, so they are
    stored normalised (geometric mean factored out) together with the host
    scalar `log_weight_scale`; observable sums computed with the normalised
    weights are multiplied by `weight_scale` on the host. This guards the
    range at any precision.
    """

    qi: torch.Tensor         # (n, d)  initial positions
    pi: torch.Tensor         # (n, d)  initial momenta
    log_prob: torch.Tensor   # (n,)    log sampling densities log P(qi, pi)
    weight: torch.Tensor     # (n,)    normalised MC weights
    logw_norm: torch.Tensor  # (n,)    log of the normalised weights
    log_weight_scale: float  # true weight = weight * exp(log_weight_scale)
    vi: torch.Tensor         # (n,) complex  <qi,pi,Gi|phi(0)>
    obs_re: torch.Tensor     # (n,)    Re log(vi/fac) + logw_norm
    obs_im: torch.Tensor     # (n,)    Im log(vi/fac)
    nacq: torch.Tensor       # (n,) complex  initial-point NAC factor of k~ic

    @property
    def weight_scale(self):
        return float(np.exp(self.log_weight_scale))


# ---------------------------------------------------------------------------
# functional core
# ---------------------------------------------------------------------------

def hk_prefactor_mat(params: HKParams, state: TrajState):
    """The prefactor matrix, complex (n, r, r):

        mat = 1/2 ( Lt_s (Mqq Ri_i - i hbar Mqp Ri_s)
                  + Lt_i (Mpp Ri_s + i/hbar Mpq Ri_i) )

    Two real matmuls. W = left @ Z puts Lt_s[a] [Mqq | Mqp] and
    Lt_i[a] [Mpq | Mpp] side by side in row a of W viewed as (r, 4d) (the
    left factor is row-interleaved for this), separately for the real and
    imaginary planes of the factor; W @ right then contracts all four
    blocks with their right factors at once, and the four plane products
    combine into the complex matrix. A diagonal-representation state is
    expanded to its dense blocks first."""
    n = state.q.shape[0]
    r, d = params.rank, params.dim
    W = torch.matmul(params.left, state.dense_Z().to(params.dtype))
    X = torch.matmul(W.view(n, 2, r, 4 * d), params.right)  # (n, 2, r, 2r)
    return torch.complex(X[:, 0, :, :r] - X[:, 1, :, r:],
                         X[:, 0, :, r:] + X[:, 1, :, :r])


def hk_prefactor_det(params: HKParams, state: TrajState):
    """C^2(t) for every trajectory, shape (n,) complex.

    When the width factors are diagonal (`factors_diag`) and the monodromy
    is in the diagonal representation, the prefactor matrix is diagonal
    and its determinant a log-space product over modes; otherwise the
    batched determinant (the CUDA kernel K1 on the card)."""
    if params.factors_diag and state.diag_monodromy:
        mqq, mqp, mpq, mpp = state.Z.to(params.dtype)
        if params.diag_k is not None:
            ka, kb, kc, ke = params.diag_k
            diag_re = 0.5 * (mqq * ka + mpp * kc)
            diag_im = 0.5 * (mpq * ke / hbar - hbar * (mqp * kb))
        else:
            Ka, Kb, Kc, Ke = params.diag_K
            diag_re = 0.5 * (mqq @ Ka + mpp @ Kc)           # (n, r)
            diag_im = 0.5 * (mpq @ Ke / hbar - hbar * (mqp @ Kb))
        return linalg.logspace_mode_product(diag_re, diag_im)
    return linalg.batched_det(hk_prefactor_mat(params, state))


def _quad(x, A, y):
    """sum_ab x_na A_ab y_nb for batches x, y of shape (n, d)."""
    return torch.sum((x @ A) * y, dim=-1)


def _nac_factor(params: HKParams, potential, x, pvec, sign, xc=None):
    """The NAC factor entering k~ic:

    nac = n2 + (q0 - x)^T R n1 + sign * i/hbar pvec . n1
    with n1 = -hbar^2 tau1/m, n2 = -hbar^2/2 sum_k tau2_k/m_k.
    sign = +1 at the initial point (q), -1 at the current point (Q).
    The difference q0 - x runs at trajectory precision (`xc` is the comp32
    residual of x, if any), the contractions at the pack's dtype.
    """
    t = params.dtype
    inv_m = 1.0 / potential.masses()
    tau1 = potential.derivative_coupling_1st(x)
    tau2 = potential.derivative_coupling_2nd(x)
    n1 = (-(hbar**2) * tau1 * inv_m[None, :]).to(t)         # (n, d)
    n2 = (-(hbar**2) * 0.5 * torch.sum(tau2 * inv_m[None, :], dim=1)).to(t)
    dq = params.q0[None, :] - x.to(params.q0.dtype)
    if xc is not None and params.q0c is not None:
        dq = dq + (params.q0c - xc)
    dq = dq.to(t)
    if params.R_diag is not None:
        core = n2 + torch.sum(dq * params.R_diag * n1, dim=1)
    else:
        core = n2 + _quad(dq, params.R, n1)
    return torch.complex(core,
                         (sign / hbar) * torch.sum(pvec.to(t) * n1, dim=1))


def _shifted_momentum(params: HKParams, p, pc=None):
    """p0 + Gamma_0 [Gi+G0]^{-1} (p - p0): the difference at trajectory
    precision (`pc` is the comp32 residual of p, if any), the contraction
    at the pack's dtype."""
    t = params.dtype
    dp = p.to(params.p0.dtype) - params.p0[None, :]
    if pc is not None and params.p0c is not None:
        dp = dp + (pc - params.p0c)
    dp = dp.to(t)
    p0 = params.p0.to(t)[None, :]
    if params.shift_diag is not None:
        return p0 + dp * params.shift_diag
    return p0 + dp @ params.shift


def hk_batch_constants(params: HKParams, qi, pi, log_prob,
                       potential, group=None) -> BatchConstants:
    """Precompute everything that depends only on the initial conditions
    (qi, pi at the sampling precision: float64 under comp32). Reads one
    scalar (the weight scale) back to the host. Under a process `group`
    the rows are this rank's shard of the batch: the weights take the
    batch's size and the weight scale its mean over every rank, so the
    ranks' sums add."""
    n = qi.shape[0] * world_of(group)
    logw = -(float(np.log(n)) + log_prob
             + params.dim * float(np.log(2.0 * np.pi * hbar)))
    log_scale = (torch.mean(logw) if group is None
                 else group_sum([torch.sum(logw)], group)[0] / n)
    logw_norm = (logw - log_scale).to(qi.dtype)
    # comp32 keeps the center split as float32 + residual; these one-time
    # constants take the full-precision center
    q0, p0 = params.q0.to(qi.dtype), params.p0.to(pi.dtype)
    if params.q0c is not None:
        q0, p0 = q0 + params.q0c.to(qi.dtype), p0 + params.p0c.to(pi.dtype)
    vi = overlap_vector(params.csoi0, qi, pi, q0, p0)
    # exponent parts of the *weighted* initial overlap: for trajectories far
    # in the tail, vi underflows while weight * vi is O(1/n) — the product
    # must live as a single fused exponent
    re_i, im_i = overlap_exponent_vector(params.csoi0, qi, pi, q0, p0)
    nacq = _nac_factor(params, potential, qi, _shifted_momentum(params, pi),
                       +1.0)
    return BatchConstants(qi=qi, pi=pi, log_prob=log_prob,
                          weight=torch.exp(logw_norm).to(params.dtype),
                          logw_norm=logw_norm,
                          log_weight_scale=float(log_scale), vi=vi,
                          obs_re=re_i + logw_norm, obs_im=im_i, nacq=nacq)


def hk_autocorr_qp(params: HKParams, bc: BatchConstants, state: TrajState,
                   c_signed):
    """Per-trajectory *weighted* contribution to the autocorrelation
    function. The weight, both overlap exponents and the action phase are
    combined into one exponent before exponentiating, so tail trajectories
    whose raw overlap underflows still contribute exactly. Under comp32 the
    residuals of the state and the center fold into the displacements."""
    if state.compensated:
        dq = (params.q0[None, :] - state.q) + (params.q0c - state.qc)
        dp = (params.p0[None, :] - state.p) + (params.p0c - state.pc)
        re_t, im_t = overlap_exponent_displaced(params.csot0, dq, dp,
                                                params.p0)
    else:
        re_t, im_t = overlap_exponent_vector(params.csot0, state.q, state.p,
                                             params.q0, params.p0)
    total_re = re_t + bc.obs_re
    total_im = (bc.obs_im - im_t) + state.S.to(re_t.dtype) / hbar
    fac = _conj(params.csot0.fac) * params.csoi0.fac
    return fac * c_signed * linalg.complex_exp(total_re, total_im,
                                               c_signed.dtype)


def _conj(fac):
    """The conjugate of an overlap prefactor: a host complex, or the 0-d
    device tensor of a time loop's pack (`_device_facs`)."""
    return fac.conj() if isinstance(fac, torch.Tensor) else fac.conjugate()


def hk_observables_qp(params: HKParams, bc: BatchConstants,
                      state: TrajState, c_signed, potential):
    """The per-trajectory contributions (cauto_qp, kic_qp), complex (n,)
    each, whose batch sums are C_auto(t) and k~ic(t)."""
    cauto_qp = hk_autocorr_qp(params, bc, state, c_signed)
    nacQ = _nac_factor(params, potential, state.q,
                       _shifted_momentum(params, state.p, state.pc), -1.0,
                       xc=state.qc)
    return cauto_qp, (1.0 / hbar**2) * nacQ * bc.nacq * cauto_qp


def hk_observables(params: HKParams, bc: BatchConstants, state: TrajState,
                   c_signed, potential):
    """(C_auto(t), k~ic(t)) reduced over the trajectory batch as 0-d device
    tensors, *without* the excited-state dynamical phase exp(i t E0/hbar)
    and the weight scale — both are applied on the host."""
    cauto_qp, kic_qp = hk_observables_qp(params, bc, state, c_signed,
                                         potential)
    return torch.sum(cauto_qp), torch.sum(kic_qp)


def second_moment(x_qp, mode=True):
    """sum_i |x_i|^2 of per-sample contributions, a 0-d device tensor.

    `mode` True treats every trajectory as a sample; "pairs" (antithetic
    sampling) first folds each interleaved +-pair into one sample — its
    members are anticorrelated by construction, so the i.i.d. formula over
    single trajectories would misstate the error. The terms are squared at
    float64: |x_i| ~ 1e-23 at 60 modes, whose square underflows float32
    but sits far above float64's range floor (the JAX package factors the
    magnitude out of a float32 sum instead)."""
    if mode == "pairs":
        x_qp = x_qp.view(-1, 2).sum(dim=1)
    x_qp = x_qp.to(torch.complex128)
    return torch.sum(x_qp.real**2 + x_qp.imag**2)


def _moments(cauto_qp, kic_qp, m2_mode):
    """The second moments of both contribution vectors, or (None, None)."""
    if not m2_mode:
        return None, None
    return second_moment(cauto_qp, m2_mode), second_moment(kic_qp, m2_mode)


def hk_coefficients(params: HKParams, bc: BatchConstants, state: TrajState,
                    c_signed):
    """Expansion coefficients v_i of the HK wavefunction in the
    coherent-state basis, without the weight scale."""
    return (c_signed * linalg.phase_exp(state.S / hbar, c_signed.dtype)
            * bc.vi * bc.weight)


def hk_log_coefficients(params: HKParams, bc: BatchConstants,
                        state: TrajState, c_signed):
    """log v_i of the fully weighted HK coefficients as two float64 tensors
    (log |v_i|, arg v_i): the range-safe form of `hk_coefficients` (the
    normalised weights alone span exp(+-O(100)) at many modes, while the
    combined exponent stays O(-log n) for every contributing trajectory)."""
    f64 = torch.float64
    fac = params.csoi0.fac
    log_re = (torch.log(torch.abs(c_signed)).to(f64) + bc.obs_re.to(f64)
              + float(np.log(abs(fac))) + bc.log_weight_scale)
    log_im = (torch.angle(c_signed).to(f64) + state.S.to(f64) / hbar
              + bc.obs_im.to(f64) + float(np.angle(fac)))
    return log_re, log_im


# ---------------------------------------------------------------------------
# the O(n^2) pair sums of the norm
# ---------------------------------------------------------------------------

# The memory one block pair's intermediates may take: the JAX package's
# default block of 4096 would form (4096, 4096, d, d) complex128 tensors in
# the WM norm (38 GB at d = 12), so the port sizes the block from this
# budget and the block term's bytes per pair (`pair_block`).
PAIR_BUDGET_BYTES = {"cuda": 2 << 30, "cpu": 32 << 20}
# bytes of intermediates per pair of the HK block term: about ten (n, n)
# float64 planes (the expanded exponents, their sums, the complex terms)
HK_PAIR_BYTES = 128


def pair_block(n, bytes_per_pair, device):
    """The block size of a pair sum: the largest b <= n with b^2
    bytes_per_pair <= PAIR_BUDGET_BYTES of the device type (2 GiB on the
    card: b = 4096 for the HK norm; 32 MiB on the CPU)."""
    kind = "cuda" if torch.device(device).type == "cuda" else "cpu"
    b = math.isqrt(PAIR_BUDGET_BYTES[kind] // int(bytes_per_pair))
    return max(1, min(int(n), b))


def _block_starts(n, block):
    return list(range(0, n, block))


def _block(arrays, start, block):
    return tuple(a[start:start + block] for a in arrays)


def blocked_pair_sum(block_term, params, arrays, block, hermitian=True,
                     pairs=None):
    """sum_ij Re term(i, j) over the block pairs of `arrays` (per-trajectory
    tensors, trajectory axis leading), as one loop on the device with one
    host read.

    `block_term(params, *blk_i, *blk_j)` returns the complex sum of one
    block pair. `hermitian`: the pair matrix is Hermitian (identical bra
    and ket widths), so the upper triangle runs and off-diagonal blocks
    count twice; otherwise the full ordered grid runs. Blocks need not
    divide n (the last one is shorter). `pairs`, if given, restricts the
    sum to those (ib, jb) block indices."""
    n = arrays[0].shape[0]
    starts = _block_starts(n, block)
    if pairs is None:
        nb = len(starts)
        pairs = [(i, j) for i in range(nb)
                 for j in (range(i, nb) if hermitian else range(nb))]
    total = torch.zeros((), dtype=torch.float64, device=arrays[0].device)
    for i, j in pairs:
        t = block_term(params, *_block(arrays, starts[i], block),
                       *_block(arrays, starts[j], block)).real
        total = total + (2.0 * t if hermitian and i != j else t)
    return float(total)


def subsampled_pair_sum(block_term, params, arrays, block, sample_pairs=512,
                        key=0, hermitian=True):
    """Unbiased estimate of the O(n^2) pair sum from a random subsample of
    off-diagonal block pairs, with its Monte-Carlo standard error.

    The diagonal block pairs (the positive |v_i|^2 mass) run exactly;
    `sample_pairs` of the P off-diagonal pairs (the upper triangle when
    `hermitian`, else the P = nb (nb - 1) ordered ones, terms not doubled)
    are drawn without replacement by a `torch.Generator` seeded with `key`:

        sum_est = diag + (P/m) sum_sample t_k
        var_est = P^2 var(t_k) / m * (1 - m/P)   (finite population)

    `block` must divide n. sample_pairs >= P gives the exact sum with
    stderr 0. Returns (sum, stderr); every block term stays on the device
    until one host read."""
    n = arrays[0].shape[0]
    if n % block:
        raise ValueError(f"the subsampled pair sum needs a block that "
                         f"divides n, got block {block} for n = {n}")
    nb = n // block
    if hermitian:
        iu, ju = torch.triu_indices(nb, nb, offset=1)
    else:
        ii, jj = torch.meshgrid(torch.arange(nb), torch.arange(nb),
                                indexing="ij")
        off = ii != jj
        iu, ju = ii[off], jj[off]
    P = int(iu.shape[0])
    m = min(int(sample_pairs), P)
    gen = torch.Generator().manual_seed(int(key))
    sel = torch.randperm(P, generator=gen)[:m]
    pairs = ([(i, i) for i in range(nb)]
             + list(zip(iu[sel].tolist(), ju[sel].tolist())))
    terms = torch.stack([
        block_term(params, *_block(arrays, i * block, block),
                   *_block(arrays, j * block, block)).real
        for i, j in pairs]).cpu().numpy()
    diag_sum = float(np.sum(terms[:nb]))
    if m == 0:
        return diag_sum, 0.0
    sampled = (2.0 if hermitian else 1.0) * terms[nb:]
    var = (P * P * float(np.var(sampled, ddof=1)) / m * (1.0 - m / P)
           if 1 < m < P else 0.0)
    return diag_sum + P * float(np.mean(sampled)), float(np.sqrt(var))


def _divisor_block(n, block):
    """The largest divisor of n that is at most `block`."""
    return next(b for b in range(min(block, n), 0, -1) if n % b == 0)


def _sqrt_norm(norm2, err2=None):
    """|psi| from the pair sum norm^2 (and its stderr, propagated through
    the square root; a sum within noise of zero returns (0, err2))."""
    if err2 is None:
        return float(np.sqrt(norm2))
    if norm2 <= 0.0:
        return 0.0, float(err2)
    norm = float(np.sqrt(norm2))
    return norm, err2 / (2.0 * norm)


def _ring_block_count(n_loc, block):
    """Blocks per shard of the ring pair sum, all of one size: a shard no
    larger than `block` is one block; otherwise `block` divides it, or the
    largest divisor of n_loc near `block` is used. One whole-shard block
    would form an (n_loc, n_loc) pair intermediate, so a shard with no
    usable divisor raises."""
    if n_loc % block == 0:
        return n_loc // block
    if n_loc <= block:
        return 1
    b = _divisor_block(n_loc, block)
    if b < block // 4:
        raise ValueError(
            f"block={block} does not divide the per-rank shard ({n_loc}) "
            "and no usable divisor exists; choose a block that divides "
            "ntraj / world")
    return n_loc // b


def _pair_sum_ring(block_term, params, arrays, group, block):
    """sum_ij Re term(i, j) over ALL ordered pairs of a batch whose rows
    are sharded over a process group: each rank keeps its shard and a
    visiting copy; for `world` rotations it adds the (local x visiting)
    block sums over every ordered block pair, then passes the visiting
    arrays one rank on (`ring_shift`). After the last rotation every
    global ordered pair was visited once; the accumulator is summed over
    the group and read on the host once. Blocks divide the shard
    (`_ring_block_count`)."""
    n_loc = arrays[0].shape[0]
    blk = n_loc // _ring_block_count(n_loc, block)
    starts = _block_starts(n_loc, blk)
    total = torch.zeros((), dtype=torch.float64, device=arrays[0].device)
    visiting = arrays
    for rotation in range(group.world):
        for i in starts:
            local = _block(arrays, i, blk)
            for j in starts:
                total = total + block_term(params, *local,
                                           *_block(visiting, j, blk)).real
        if rotation + 1 < group.world:
            visiting = ring_shift(visiting, group)
    return float(group_sum([total], group)[0])


def _pair_sum(block_term, params, arrays, block, group, hermitian=True):
    """The pair sum of a single process (`blocked_pair_sum`), or the ring
    over the ranks of `group` (every ordered pair)."""
    if group is not None:
        return _pair_sum_ring(block_term, params, arrays, group, block)
    return blocked_pair_sum(block_term, params, arrays, block, hermitian)


def _hk_norm_block_term(ov, qi, pi, vi, qj, pj, vj):
    return torch.einsum("i,ij,j->", vi.conj(), overlap_matrix(ov, qi, pi, qj,
                                                              pj), vj)


def _hk_norm_log_block_term(ov, qi, pi, lri, lii, qj, pj, lrj, lij):
    """conj(v_i) <g_i|g_j> v_j of one block pair, each entry assembled as
    ONE exponent (log-coefficients + pair-overlap exponent + log fac):
    finite wherever the true pair term is; at the pack's dtype."""
    re, im = overlap_exponent_matrix(ov, qi, pi, qj, pj)
    rd = re.dtype
    total_re = (lri.to(rd)[:, None] + lrj.to(rd)[None, :] + re
                + float(np.log(abs(ov.fac))))
    total_im = (-lii.to(rd)[:, None] + lij.to(rd)[None, :] + im
                + float(np.angle(ov.fac)))
    return torch.sum(linalg.complex_exp(total_re, total_im,
                                        linalg.complex_dtype(rd)))


def _no_sampled_ring(sample_pairs, group):
    if sample_pairs is not None and group is not None:
        raise ValueError(
            "subsampled norm (sample_pairs / norm_samples): single-process "
            "route only — the ring over a process group is already "
            "O(n^2 / world) per rank; run it without sample_pairs")


def pairwise_norm(ov: OverlapParams, q, p, v, block=None, group=None):
    """|psi| = sqrt(sum_ij v_i^* <g_i|g_j> v_j) from linear coefficients,
    by blocked accumulation over the Hermitian upper triangle, or under a
    process `group` (q, p, v this rank's shard) by the ring over every
    ordered pair (`_pair_sum_ring`). O(n^2): an opt-in convergence
    diagnostic."""
    if block is None:
        block = pair_block(q.shape[0], HK_PAIR_BYTES, q.device)
    return _sqrt_norm(_pair_sum(_hk_norm_block_term, ov, (q, p, v), block,
                                group))


def pairwise_norm_log(ov: OverlapParams, q, p, log_v, block=None,
                      sample_pairs=None, key=0, group=None):
    """|psi| from log-coefficients — the range-safe pairwise norm (under a
    process `group`, the ring as in `pairwise_norm`).

    With `sample_pairs` (a single process only): the subsampled estimate
    (`subsampled_pair_sum`, at the largest block that divides n) as
    (norm, stderr), the stderr propagated through the square root."""
    _no_sampled_ring(sample_pairs, group)
    n = q.shape[0]
    if block is None:
        block = pair_block(n, HK_PAIR_BYTES, q.device)
    arrays = (q, p, *log_v)
    if sample_pairs is not None:
        return _sqrt_norm(*subsampled_pair_sum(
            _hk_norm_log_block_term, ov, arrays, _divisor_block(n, block),
            sample_pairs=sample_pairs, key=key))
    return _sqrt_norm(_pair_sum(_hk_norm_log_block_term, ov, arrays, block,
                                group))


# ---------------------------------------------------------------------------
# sub-batches of the micro-batched time loop
# ---------------------------------------------------------------------------

def _batch_rows(obj, a, b):
    """Trajectories a:b of a per-batch object (TrajState, a tracker, the
    batch constants): every tensor field sliced along its trajectory axis
    (axis 1 of a diagonal-representation monodromy), nested packs likewise,
    scalars kept. The slices are views."""
    if isinstance(obj, TrajState):
        Z = obj.Z[:, a:b] if obj.diag_monodromy else obj.Z[a:b]
        rows = lambda x: None if x is None else x[a:b]
        return TrajState(q=obj.q[a:b], p=obj.p[a:b], Z=Z, S=obj.S[a:b],
                         qc=rows(obj.qc), pc=rows(obj.pc))
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v[a:b]
        elif dataclasses.is_dataclass(v):
            v = _batch_rows(v, a, b)
        fields[f.name] = v
    return dataclasses.replace(obj, **fields)


def _tree_rows(tree, a, b):
    """`_batch_rows` of each entry of a tuple (None kept)."""
    return tuple(None if x is None else _batch_rows(x, a, b) for x in tree)


def _only(obj, keep):
    """A dataclass with every field but those named in `keep` set to
    None."""
    return dataclasses.replace(obj, **{
        f.name: None for f in dataclasses.fields(obj) if f.name not in keep})


def _device_facs(params: HKParams):
    """The HK pack as the time loop's blocks read it: csoi0 and csot0 with
    their prefactor `fac` as a 0-d complex128 device tensor; csott and wf
    (the norm's and the grid's, which no step reads) None."""
    def fac(ov):
        return dataclasses.replace(ov, fac=torch.tensor(
            complex(ov.fac), dtype=torch.complex128,
            device=ov.Gi_iGij_Gj.device))

    return dataclasses.replace(params, csoi0=fac(params.csoi0),
                               csot0=fac(params.csot0), csott=None, wf=None)


@dataclass
class _MorseCache:
    """The exact Morse map of a propagator: its constants, its carry, and
    the (dt, potential, state) it belongs to."""

    dt: float
    potential: object
    state: TrajState
    pack: MorseMapPack
    carry: MorseMapCarry


def check_energy_conservation(energies, change_tol=1.0e-2):
    """Post-propagation guard: raise if the batch-mean <T+V> drifts between
    steps or if the trace contains NaNs."""
    energies = np.asarray(energies)
    if np.isnan(energies).any():
        raise RuntimeError("NaN encountered in trajectory energies")
    change = np.abs(np.diff(energies))
    if change.size and change.max() > change_tol:
        step = int(np.argmax(change))
        logger.error("  energy conservation violated")
        logger.error(
            f"  <T+V>(t-dt)= {energies[step]}, <T+V>(t)= {energies[step + 1]}"
        )
        raise RuntimeError(
            "average energy of classical trajectories is not conserved, "
            f"change= {change.max()} Hartree"
        )


# ---------------------------------------------------------------------------
# stateful propagator
# ---------------------------------------------------------------------------

class HermanKlukPropagator:
    """HK propagation of one trajectory batch on one device.

    `initial_conditions` samples the batch and builds its constants,
    `propagate` runs `nt` steps and returns C(t) and k~ic(t) (and their
    per-step standard errors with `error_bars`), `step` advances one step;
    the granular accessors (`semiclassical_prefactor`, `autocorrelation`,
    `ic_correlation`, `coefficients`, `log_coefficients`, `norm`,
    `wavefunction`, the state accessors) read the current state.

    `integrator` is "rk4" (fixed-step Runge-Kutta) or "exact" (no
    time-discretization error at any dt: the affine map of a
    constant-Hessian molecular PES, or the closed-form map of a
    non-harmonic separable Morse PES with its RK4 side-channel), in every
    precision mode.

    `dtype` (torch.float64 or torch.float32) is the precision of the
    parameter packs, the monodromy and all complex algebra (complex128 or
    complex64); `traj_dtype` that of q, p and S (default `dtype`), or
    "comp32": float32 q and p with float32 Neumaier residuals, float64 S
    and float64 sampling, which requires `dtype` float32. The JAX
    package's modes: "f64" (float64, float64), "mixed" (float32, float64),
    "comp32" (float32, "comp32"), "f32" (float32, float32).
    """

    def __init__(self, Gamma_i, Gamma_t, device, integrator="rk4",
                 dtype=torch.float64, traj_dtype=None):
        if integrator not in ("rk4", "exact"):
            raise ValueError(f"unknown integrator {integrator!r} "
                             "(expected 'rk4' or 'exact')")
        traj_dtype = dtype if traj_dtype is None else traj_dtype
        reals = (torch.float32, torch.float64)
        if dtype not in reals or traj_dtype not in (*reals, "comp32"):
            raise ValueError(
                f"dtype must be torch.float32 or torch.float64 and "
                f"traj_dtype one of them or 'comp32', got {dtype} and "
                f"{traj_dtype}")
        if traj_dtype == "comp32" and dtype != torch.float32:
            raise ValueError("comp32 trajectories require dtype=float32")
        self.dtype = dtype
        self.traj_dtype = traj_dtype
        self.integrator = integrator
        self._invalidate_map()
        Gamma_i = np.asarray(Gamma_i, dtype=np.float64)
        Gamma_t = np.asarray(Gamma_t, dtype=np.float64)
        for name, G in (("Gamma_i", Gamma_i), ("Gamma_t", Gamma_t)):
            if not linalg.is_symmetric_non_negative(G):
                raise ValueError(
                    f"{name} has to be symmetric and positive semi-definite.")
        self.Gamma_i = Gamma_i
        self.Gamma_t = Gamma_t
        self.device = torch.device(device)
        self.state = None
        self.group = None
        self.last_energies = np.zeros(0)
        # sub-batch size of the time loop (0: the whole batch at once)
        self.micro_batch = 0
        self.sampling_method = "pseudo"

    @property
    def n_local(self):
        """The trajectories this process propagates: the batch, or this
        rank's shard of it under a group."""
        return self.state.q.shape[0]

    @property
    def compensated(self):
        """True in the comp32 mode."""
        return self.traj_dtype == "comp32"

    @property
    def cdtype(self):
        """The complex dtype of the observables."""
        return linalg.complex_dtype(self.dtype)

    def initial_conditions(self, q0, p0, Gamma_0, potential, ntraj=5000,
                           generator=None, normals=None,
                           sampling_method="pseudo", group=None):
        """Sample initial phase-space points and initialise the state.

        Parameters
        ----------
        q0, p0 : (d,) center and momentum of the initial wavepacket
        Gamma_0 : (d, d) width matrix of the initial wavepacket
        potential : the PES; its Hessian operator decides the monodromy
            representation (a `ConstHessian` or a `DenseHessian` gives the
            dense one, a `DiagHessian` the diagonal one)
        ntraj : number of trajectories
        generator : torch.Generator on the propagator's device
        normals : optional (ntraj, 2 rank) standard normals used in place
            of the generator's draws
        sampling_method : "pseudo" | "antithetic" | "sobol", the draw of
            the standard normals (`sampling.standard_normals`); with
            "antithetic" the error bars count each +-pair as one sample
        group : a `parallel.Group` whose ranks share this batch, or None.
            ntraj is rounded up to a multiple of its size (of twice its
            size under "antithetic": +-pairs must not straddle shards);
            every rank draws the whole batch from the same generator (or
            takes the whole `normals`) and keeps its own rows. `ntraj`
            stays the batch's size; the state holds this rank's rows.

        The draws are made at float64 in every mode and the points cast to
        the trajectory dtype (float64 under comp32, whose state splits
        them), so a float32 run starts from the float64 run's points
        rounded; the log-densities stay float64.
        """
        q0 = np.asarray(q0, dtype=np.float64)
        p0 = np.asarray(p0, dtype=np.float64)
        Gamma_0 = np.asarray(Gamma_0, dtype=np.float64)
        sampling = SamplingParams.create(q0, p0, Gamma_0, self.Gamma_i,
                                         self.device)
        self.sampling = sampling
        self.sampling_method = sampling_method
        self.group = group
        if group is not None:
            ntraj = pad_to_multiple(
                ntraj, group.world * (2 if sampling_method == "antithetic"
                                      else 1))
        self.params = self._make_params(Gamma_0, q0, p0, sampling)
        logger.info("== Initial Conditions ==")
        logger.info(f"number of dimensions   :  {self.params.dim}")
        logger.info(f"zero dimensions        :  "
                    f"{self.params.dim - self.params.rank}")
        logger.info(f"number of trajectories :  {ntraj}")

        if normals is None:
            normals = standard_normals(sampling, ntraj, sampling_method,
                                       generator)
        qi, pi, log_prob = sample_initial_conditions(sampling, ntraj,
                                                     normals=normals)
        log_sampling_statistics(sampling, qi, pi)
        a, b = shard_rows(ntraj, group)
        qi, pi, log_prob = qi[a:b], pi[a:b], log_prob[a:b]
        if not self.compensated:
            qi, pi = qi.to(self.traj_dtype), pi.to(self.traj_dtype)
        hess = potential.local_expansion(qi[:1])[2]
        if not isinstance(hess, (ConstHessian, DenseHessian, DiagHessian)):
            raise NotImplementedError(
                "the port propagates the dense monodromy under ConstHessian "
                "or DenseHessian expansions and the diagonal monodromy under "
                f"DiagHessian ones; this potential gives "
                f"{type(hess).__name__}")
        self.state = TrajState.initial(
            qi, pi, mono_dtype=self.dtype,
            diag_monodromy=isinstance(hess, DiagHessian),
            compensated=self.compensated)
        self.bc = self._make_batch_constants(qi, pi, log_prob, potential)
        self.tracker = self._make_trackers(self.state)
        self.ntraj = ntraj
        self.t = 0.0
        self._invalidate_map()

    # -- hooks shared with the WM subclass -----------------------------------

    def _make_params(self, Gamma_0, q0, p0, sampling):
        """The constant parameter pack."""
        return build_hk_params(self.Gamma_i, self.Gamma_t, Gamma_0, q0, p0,
                               sampling.U, sampling.iGi0, self.device,
                               self.dtype, self.traj_dtype)

    def _make_batch_constants(self, qi, pi, log_prob, potential):
        """The per-batch constants of the sampled initial conditions."""
        return hk_batch_constants(self.params, qi, pi, log_prob, potential,
                                  self.group)

    def _make_trackers(self, state):
        """The branch-cut tracking state at the initial conditions."""
        return SignTracker.fresh(hk_prefactor_det(self.params, state))

    def _loop_constants(self, bc):
        """The batch constants as the time loop's blocks read them: the
        fields `_observe` reads, every other one None (a block that read
        one would fail), `log_weight_scale` among them: it is applied on
        the host after the loop."""
        return _only(bc, ("obs_re", "obs_im", "nacq"))

    def _loop_params(self):
        """The parameter pack as the time loop's blocks read it: the
        overlap prefactors `fac` as 0-d device tensors, so that a pack of
        another Gamma_0 loads into a kept loop instead of being baked into
        its graphs."""
        return _device_facs(self.params)

    @staticmethod
    def _observe(params, state, tracker, potential, bc, m2_mode=False):
        """One step's observables: the tracker advanced to `state`, the
        (C_auto, k~ic) batch sums as 0-d device tensors, and their second
        moments (`second_moment`; None unless `m2_mode`). Reads nothing of
        a propagator: a kept loop's blocks run it for every batch."""
        tracker = tracker.update(hk_prefactor_det(params, state))
        cauto_qp, kic_qp = hk_observables_qp(params, bc, state,
                                             tracker.sqrt(), potential)
        return (tracker, torch.sum(cauto_qp), torch.sum(kic_qp),
                *_moments(cauto_qp, kic_qp, m2_mode))

    def _micro_k(self, m2_mode):
        """The number of sub-batches of the time loop: rows / micro_batch
        when `micro_batch` is set, smaller than this process's rows (its
        shard under a group) and divides them; else 1 (with a warning
        where it does not divide)."""
        m, n = int(self.micro_batch or 0), self.n_local
        if m <= 0 or n <= m:
            return 1
        if self.integrator == "exact":
            logger.info(f"micro_batch={m} is ignored with integrator "
                        "'exact': the whole batch runs at once")
            return 1
        if n % m:
            logger.warning(f"micro_batch={m} does not divide the batch "
                           f"({n}); running the whole batch")
            return 1
        if m2_mode == "pairs" and m % 2:
            raise ValueError(
                f"antithetic error bars need an even micro-batch size, got "
                f"{m} (= {n} trajectories / {n // m} sub-batches) — "
                "interleaved +-pairs must not straddle a sub-batch boundary")
        return n // m

    def _invalidate_map(self):
        """Drop the exact Morse map's cached constants and carry (a new
        batch, a restored checkpoint). The time loop is not the
        propagator's: the process holds it (`graph.segment_graph`), and
        the next `_run` loads the new batch into it."""
        self._morse = None    # _MorseCache

    @property
    def _loop(self):
        """The time loop that the process holds for this device."""
        return graph.live(self.device)

    def _window(self, potential):
        """The taylor_every window of the RK4 loop (1 elsewhere)."""
        if self.integrator == "exact":
            return 1
        return int(getattr(potential, "taylor_every", 1) or 1)

    def _stepper(self, potential, dt):
        """(fresh, advance, window) of the time loop, from what the loop's
        key holds (the potential, dt, the state's representation and
        dtypes): `fresh(state, carry, pack)` gives the state and carry at
        the head of a scan segment (`carry` the previous segment's, or the
        batch's first), `advance(state, carry, pack)` one step as (new
        state, mean energy at the step start, new carry); `pack` is the
        exact Morse map's per-batch constants (None elsewhere, see
        `_morse_map`). `window` is the taylor_every window, whose carry
        restarts at the head of every block (1 elsewhere: the carry
        persists). Nothing of the propagator is held: the loop keeps the
        stepper for every batch it runs."""
        if self.integrator == "exact":
            return self._exact_stepper(potential, dt)
        every = self._window(potential)
        if every > 1:
            if getattr(potential, "hessian_eval", "stage") != "taylor":
                raise ValueError(
                    "taylor_every > 1 requires hessian_eval='taylor'")
            window0, window_step = make_taylor_window(potential, dt, every)
            return ((lambda state, carry, pack: (state, window0(state))),
                    (lambda state, carry, pack: window_step(state, carry)),
                    every)
        step_map = None
        if not self.state.diag_monodromy:
            hess = potential.local_expansion(self.state.q[:1])[2]
            if isinstance(hess, ConstHessian):
                step_map = const_step_map(hess, potential.masses(), dt,
                                          self.state.Z.dtype)

        def advance(state, carry, pack):
            return (*rk4_step(state, potential, dt, step_map), carry)

        return (lambda state, carry, pack: (state, None)), advance, 1

    def _exact_stepper(self, potential, dt):
        """The exact map's (fresh, advance, window): the harmonic map of
        (potential, dt) built here, or the Morse map, whose per-batch pack
        and carry come from `_morse_map`."""
        dt = float(dt)
        if supports_exact_harmonic(potential):
            hmap = build_harmonic_map(potential, dt, self.state)

            def advance(state, carry, pack):
                return (*harmonic_step(hmap, state, potential), carry)

            return (lambda state, carry, pack: (state, None)), advance, 1

        def fresh(state, carry, pack):
            return morse_map_state(pack, carry), carry

        def advance(state, carry, pack):
            carry, energy = morse_map_advance(pack, carry, dt, potential)
            return morse_map_state(pack, carry), energy, carry

        return fresh, advance, 1

    def _morse_map(self, potential, dt):
        """(pack, carry) of the exact Morse map of this batch, or (None,
        None) off that path. Its constants and carry persist across
        segments and calls while dt, the potential object and the state
        object stay those it advanced (objects compared by retained
        identity, so a replaced state or potential rebuilds it)."""
        if self.integrator != "exact" or supports_exact_harmonic(potential):
            return None, None
        dt = float(dt)
        cache = self._morse
        if (cache is None or cache.dt != dt or cache.potential is not potential
                or cache.state is not self.state):
            if not supports_exact_morse(potential, self.state):
                raise ValueError(
                    "integrator='exact' requires a non-harmonic separable "
                    "MorsePotential (diagonal-monodromy state) or a "
                    "constant-Hessian molecular harmonic potential; use "
                    "integrator='rk4' for this potential")
            pack, carry = build_morse_map(self.state, potential, dt,
                                          self.group)
            cache = self._morse = _MorseCache(dt, potential, self.state,
                                              pack, carry)
        return cache.pack, cache.carry

    def _segment_graph(self, potential, dt, m2_mode, k):
        """(the device's time loop for this call, the head of the first
        segment (state, trackers, carry) of the whole batch, the batch
        constants as the blocks read them). The loop's static buffers
        hold one sub-batch's rows (n / k): the carried head, then the
        inputs (the parameter pack, the batch constants, the Morse map's
        pack). The loop is the kept one while its key holds, whatever
        propagator or batch ran it before: the class, integrator and
        precision, the potential (by identity), dt, the error-bar mode,
        the sub-batch count and the `graph.signature` of every static
        tree (shapes, dtypes, structure and the packs' host scalars); a
        new one otherwise, which keeps the stepper its blocks call. The
        inputs are loaded here, and with one sub-batch the head too."""
        pack, carry = self._morse_map(potential, dt)
        state = self.state if pack is None else morse_map_state(pack, carry)
        head = (state, self.tracker,
                None if self._window(potential) > 1 else carry)
        bc = self._loop_constants(self.bc)
        m = self.n_local // k
        inputs = (self._loop_params(),
                  bc if k == 1 else _batch_rows(bc, 0, m), pack)
        static = (*(head if k == 1 else _tree_rows(head, 0, m)), *inputs)
        key = (potential, type(self), self.integrator, self.dtype,
               self.traj_dtype, float(dt), m2_mode, k,
               graph.signature(static))
        loop, new = graph.segment_graph(
            key, self.device, lambda: (graph.clone_tree(static),
                                       self._stepper(potential, dt)))
        if not new:
            graph.copy_tree(loop.static[3:], inputs)
            if k == 1:
                graph.copy_tree(loop.static[:3], head)
        return loop, head, bc

    def _block(self, loop, length, potential, m2_mode):
        """(body, slots) of one block: `length` steps on the loop's static
        buffers (one sub-batch's rows), the first restarting a
        taylor_every window; each step's (C_auto, k~ic), mean energy and
        second moments go into the slots, the state, the trackers and a
        persisting carry back into the buffers. The body reads the
        parameter pack, the batch constants and the Morse map's pack from
        the buffers, never from this propagator: every batch the loop
        runs goes through it."""
        fresh, advance, window = loop.stepper
        observe = self._observe
        state, tracker, carry, params, bc, pack = loop.static
        slots = (torch.empty(2, length, dtype=self.cdtype,
                             device=self.device),
                 torch.empty(length, dtype=state.q.dtype, device=self.device),
                 torch.empty(2, length, dtype=torch.float64,
                             device=self.device) if m2_mode else None)

        def body():
            st, tr, cr = state, tracker, carry
            if window > 1:
                st, cr = fresh(st, None, pack)
            sums, energies, moments = ([], []), [], ([], [])
            for _ in range(length):
                tr, c, k, m2c, m2k = observe(params, st, tr, potential, bc,
                                             m2_mode)
                st, energy, cr = advance(st, cr, pack)
                sums[0].append(c)
                sums[1].append(k)
                energies.append(energy)
                if m2_mode:
                    moments[0].append(m2c)
                    moments[1].append(m2k)
            slots[0].copy_(torch.stack(sums[0] + sums[1]).view(2, length))
            slots[1].copy_(torch.stack(energies))
            if m2_mode:
                slots[2].copy_(torch.stack(moments[0] + moments[1]).view(
                    2, length))
            graph.copy_tree((state, tracker, carry),
                            (st, tr, cr if window == 1 else None))

        return body, slots

    def _run(self, potential, dt, nt, chunk=None, progress=None,
             m2_mode=False):
        """The time loop: `nt` steps from the current state, in scan
        segments of at most `chunk` steps, each segment sub-batch by
        sub-batch under `micro_batch`, each sub-batch's segment in blocks
        of `graph.block_lengths` — on the card captured CUDA graphs,
        replayed (`graph.SegmentGraph`), elsewhere and under
        `graph.eager()` the same blocks run eagerly. Returns the device
        tensors (cauto, kic, energies) of length nt and the second moments
        (2, nt) (None unless `m2_mode`); sub-batch sums and moments add,
        energies average.

        The sub-batches share the loop's blocks, one per length (the JAX
        package's `lax.map` over one compiled body): before the first
        block of a sub-batch in a segment its rows of the state, the
        trackers and the batch constants are copied into the loop's
        buffers, after its last block the state and the trackers back.

        A `taylor_every` window (`eom.make_taylor_window`) restarts at the
        head of every segment, as the JAX package's scans do, so `chunk`
        is part of the result there; `self.state` and the trackers are
        materialised at the end of every segment, where the group reduces
        and `progress`, if given, is called (one host read per
        segment)."""
        if chunk is None or chunk >= nt:
            segments = [nt]
        else:
            segments = [chunk] * (nt // chunk) + ([nt % chunk]
                                                   if nt % chunk else [])
        k = self._micro_k(m2_mode)
        m = self.n_local // k
        loop, head, bc = self._segment_graph(potential, dt, m2_mode, k)
        window = loop.stepper[2]
        carried = loop.static[:3]
        whole = carried if k == 1 else graph.clone_tree(head)
        sums = torch.empty(2, k, nt, dtype=self.cdtype, device=self.device)
        energies = torch.empty(k, nt, dtype=self.state.q.dtype,
                               device=self.device)
        m2 = (torch.empty(2, k, nt, dtype=torch.float64, device=self.device)
              if m2_mode else None)
        done = 0
        for seg in segments:
            for s in range(k):
                rows = (s * m, (s + 1) * m)
                if k > 1:
                    graph.copy_tree(carried, _tree_rows(whole, *rows))
                    graph.copy_tree(loop.static[4], _batch_rows(bc, *rows))
                i = done
                for length in graph.block_lengths(seg, window):
                    obs, energy, moments = loop.run(
                        length, lambda: self._block(loop, length, potential,
                                                    m2_mode))
                    sums[:, s, i:i + length] = obs
                    energies[s, i:i + length] = energy
                    if m2_mode:
                        m2[:, s, i:i + length] = moments
                    i += length
                if k > 1:
                    graph.copy_tree(_tree_rows(whole, *rows), carried)
            if self.group is not None:
                self._reduce_segment(slice(done, done + seg), sums[0],
                                     sums[1], energies, m2)
            done += seg
            self.state, self.tracker, carry = graph.clone_tree(whole)
            if self._morse is not None:
                # the map's carry advanced with the state
                self._morse.state, self._morse.carry = self.state, carry
            if progress is not None and chunk:
                progress(done, nt, complex(torch.sum(sums[0, :, done - 1]))
                         * self.bc.weight_scale)
        self.t += nt * float(dt)
        cauto, kic = sums
        if k == 1:
            return cauto[0], kic[0], energies[0], (None if m2 is None
                                                   else m2[:, 0])
        return (cauto.sum(dim=0), kic.sum(dim=0), energies.mean(dim=0),
                None if m2 is None else m2.sum(dim=1))

    def _reduce_segment(self, steps, cauto, kic, energies, m2):
        """Replace one segment's columns (`steps`) of the per-rank sums
        and moments by their sums over the group, and of the per-rank mean
        energies by their group mean (equal shards), in one all-reduce."""
        parts = [cauto[:, steps], kic[:, steps], energies[:, steps]]
        if m2 is not None:
            parts.append(m2[:, :, steps])
        parts = group_sum(parts, self.group)
        cauto[:, steps], kic[:, steps] = parts[0], parts[1]
        energies[:, steps] = parts[2] / self.group.world
        if m2 is not None:
            m2[:, :, steps] = parts[3]

    def propagate(self, potential, dt, nt, energy0_es=0.0, check_energy=True,
                  chunk=None, progress=None, error_bars=False,
                  micro_batch=None):
        """Run `nt` steps.

        Returns (autocorrelation (nt,), ic_correlation (nt,)) as numpy
        arrays sampled at t0, t0 + dt, ..., t0 + (nt-1) dt; the state
        advances by nt steps. The run goes in segments of at most `chunk`
        steps (a `taylor_every` window restarts at each); `progress`, if
        given, is called after every segment with (steps_done, nt, C(t) at
        the last step) — the one host read per segment. The per-step
        batch-mean energies of the run are kept in `self.last_energies`.

        `error_bars=True` returns a 4-tuple (cauto, kic, cauto_stderr,
        kic_stderr): the per-step Monte-Carlo standard errors of the
        complex means, sigma = sqrt(sum_i |x_i|^2 - |sum_i x_i|^2 / n) over
        the weighted contributions x_i (n samples: the trajectories, or the
        +-pairs of an antithetic batch), invariant under the host phase.

        `micro_batch`, if given, sets `self.micro_batch`: every segment
        runs sub-batch by sub-batch (per-trajectory results unchanged, the
        batch sums re-associate); ignored where it does not divide the
        batch.
        """
        if micro_batch is not None:
            self.micro_batch = int(micro_batch)
        m2_mode = False
        if error_bars:
            m2_mode = "pairs" if self.sampling_method == "antithetic" else True
            if m2_mode == "pairs" and self.integrator == "exact":
                # the JAX package's rule, kept so the npz matches its CLI's
                logger.warning(
                    "error_bars + antithetic sampling + integrator='exact': "
                    "per-trajectory (conservative) stderr formula used — "
                    "the side-channel split breaks pair bookkeeping")
                m2_mode = True
        t_start = self.t
        cauto, kic, energies, m2 = self._run(potential, dt, nt, chunk,
                                             progress, m2_mode)
        cauto = cauto.cpu().numpy().astype(np.complex128)
        kic = kic.cpu().numpy().astype(np.complex128)
        self.last_energies = energies.cpu().numpy()
        if check_energy:
            check_energy_conservation(self.last_energies)
        ts = t_start + float(dt) * np.arange(nt)
        phase = np.exp(1j / hbar * energy0_es * ts)
        scale = self.bc.weight_scale
        out = (cauto * scale * phase, kic * scale * phase)
        if not error_bars:
            return out
        n = self.ntraj // 2 if m2_mode == "pairs" else self.ntraj
        m2 = m2.cpu().numpy()
        return (*out, *(scale * np.sqrt(np.maximum(
            moment - np.abs(total) ** 2 / n, 0.0))
            for moment, total in zip(m2, (cauto, kic))))

    def step(self, potential, dt):
        """Advance one time step t -> t + dt (updates the sign tracker)."""
        self._run(potential, dt, 1)

    # -- granular API ---------------------------------------------------------

    def _phase(self, energy0_es):
        return np.exp(1j / hbar * self.t * energy0_es)

    def _batch_sum(self, x):
        """A 0-d sum over this process's rows as a host complex, summed
        over the group's ranks under a group."""
        return complex(group_sum([x], self.group)[0])

    def semiclassical_prefactor(self):
        """The sign-aligned HK prefactor C(t) at the current state, (n,)
        complex; advances the tracker to the state first (a no-op when it
        is already there)."""
        self.tracker = self.tracker.update(hk_prefactor_det(self.params,
                                                            self.state))
        return self.tracker.sqrt()

    def autocorrelation(self, energy0_es=0.0):
        """C(t) at the current state (of the whole batch under a group)."""
        c = self.semiclassical_prefactor()
        cauto = torch.sum(hk_autocorr_qp(self.params, self.bc, self.state, c))
        return (self._batch_sum(cauto) * self.bc.weight_scale
                * self._phase(energy0_es))

    def ic_correlation(self, potential, energy0_es=0.0):
        """k~ic(t) at the current state (of the whole batch under a
        group)."""
        c = self.semiclassical_prefactor()
        _, kic = hk_observables(self.params, self.bc, self.state, c,
                                potential)
        return (self._batch_sum(kic) * self.bc.weight_scale
                * self._phase(energy0_es))

    def coefficients(self):
        """The linear coefficients v_i, weight scale included; they
        over/underflow where the true magnitude does (`log_coefficients`
        is exact at any mode count). Under a group: this rank's rows, as
        for every per-trajectory accessor."""
        v = hk_coefficients(self.params, self.bc, self.state,
                            self.semiclassical_prefactor())
        return v * self.bc.weight_scale

    def _log_coefficients(self):
        return hk_log_coefficients(self.params, self.bc, self.state,
                                   self.semiclassical_prefactor())

    def log_coefficients(self):
        """(log |v|, arg v) as float64 numpy arrays."""
        return tuple(x.cpu().numpy() for x in self._log_coefficients())

    def norm(self, sample_pairs=None, key=0, block=None):
        """|psi| of the frozen-Gaussian wavefunction (O(n^2), diagnostic),
        from log-coefficients; `block` defaults to `pair_block`'s rule.
        With `sample_pairs`: the subsampled estimate (norm, stderr), on a
        single process only. Under a group the ring over every ordered
        pair of the batch (`_pair_sum_ring`), a collective: every rank
        calls it."""
        return pairwise_norm_log(self.params.csott, self.state.q,
                                 self.state.p, self._log_coefficients(),
                                 block=block, sample_pairs=sample_pairs,
                                 key=key, group=self.group)

    def _batch_grid(self, psi, zmax):
        """The host grid values psi exp(zmax) of this process's rows,
        summed over the group's ranks under a group."""
        psi = (psi.cpu().numpy().astype(np.complex128)
               * np.exp(zmax.cpu().numpy().astype(np.float64)))
        if self.group is None:
            return psi
        return group_sum([torch.as_tensor(psi, device=self.device)],
                         self.group)[0].cpu().numpy()

    def wavefunction(self, x):
        """psi(x, t) on a grid x (nx, d), complex numpy (nx,), from
        log-coefficients with the exponent shift recombined on the host
        (of the whole batch under a group)."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)
        return self._batch_grid(*wavefunction_log(
            self.params.wf, self.state.q, self.state.p,
            self._log_coefficients(), x))

    def initial_positions_and_momenta(self):
        return self.bc.qi, self.bc.pi

    def current_positions_and_momenta(self):
        return self.state.q, self.state.p

    def classical_action(self):
        return self.state.S

    def monodromy_matrices(self):
        """The monodromy blocks (Mqq, Mqp, Mpq, Mpp), each (n, d, d) with
        the trajectory axis leading (the diagonal representation
        expanded)."""
        Z, d = self.state.dense_Z(), self.state.dim
        return Z[:, :d, :d], Z[:, :d, d:], Z[:, d:, :d], Z[:, d:, d:]
