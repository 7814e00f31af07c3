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
* `propagate` runs the time loop in Python, in scan segments of `chunk`
  steps (a `taylor_every` window of an sGDML potential restarts at each,
  as in the JAX package), with every per-step result written into
  preallocated device tensors — no host synchronisation per step. C(t),
  k~ic(t) and the batch-mean energies come to the host once per call,
  where the energy-conservation guard and the separable phases apply.
  With `error_bars` every step also writes the second moments
  sum_i |x_i|^2 of both per-trajectory contribution vectors, which become
  the per-step Monte-Carlo standard errors on the host; with
  `micro_batch` every segment runs sub-batch by sub-batch and the sums
  and moments add up (the JAX package's `_micro_scan`);
* the granular API (`semiclassical_prefactor`, `autocorrelation`,
  `coefficients`, `norm`, `wavefunction`, ...) works on the current state;
  the O(n^2) norm is a loop over block pairs on the device with one host
  read (`blocked_pair_sum`, `subsampled_pair_sum`), its block size chosen
  from a memory budget (`pair_block`).
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
                                              overlap_exponent_matrix,
                                              overlap_exponent_vector,
                                              overlap_matrix, overlap_vector,
                                              wavefunction_log)
from semiclassical_tpu_torch.potentials.base import (ConstHessian,
                                                     DenseHessian,
                                                     DiagHessian)
from semiclassical_tpu_torch.propagation.eom import (const_step_map,
                                                     make_taylor_window,
                                                     rk4_step)
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

    @property
    def factors_diag(self):
        return self.diag_K is not None

    @staticmethod
    def from_factors(Lt_s, Lt_i, Ri_s, Ri_i, q0, p0, G0, iGi0, R,
                     csoi0, csot0, device, diag=None, csott=None, wf=None):
        """Pack the complex factors (host numpy) for the device. The
        separable-path fields diag_k, R_diag and shift_diag are derived
        here unless given (as the dict `diag`)."""
        Lt_s, Lt_i = np.asarray(Lt_s), np.asarray(Lt_i)      # (r, d)
        Ri_s, Ri_i = np.asarray(Ri_s), np.asarray(Ri_i)      # (d, r)
        r, d = Lt_s.shape
        lint = np.zeros((2 * r, 2 * d), dtype=np.complex128)
        lint[0::2, :d] = Lt_s
        lint[1::2, d:] = Lt_i
        rst = 0.5 * np.concatenate([Ri_i, -1j * hbar * Ri_s,
                                    (1j / hbar) * Ri_i, Ri_s], axis=0)
        t = lambda x: None if x is None else torch.tensor(
            np.asarray(x, dtype=np.float64), device=device)
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
            q0=t(q0), p0=t(p0), R=t(R), shift=t(shift),
            csoi0=csoi0, csot0=csot0, dim=int(d), rank=int(r),
            diag_K=t(diag_K), **{k: t(v) for k, v in diag.items()},
            csott=csott, wf=wf)


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


def build_hk_params(Gamma_i, Gamma_t, Gamma_0, q0, p0, U, iGi0, device):
    """HKParams from the width matrices, the wavepacket center and the
    sampling subspace U (d, r) / pseudo-inverse iGi0 (host numpy)."""
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
        csoi0=OverlapParams.create(Gamma_i, Gamma_0, device),
        csot0=OverlapParams.create(Gamma_t, Gamma_0, device),
        device=device,
        csott=OverlapParams.create(Gamma_t, Gamma_t, device),
        wf=WavefunctionParams.create(Gamma_t, device))


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
    W = torch.matmul(params.left, state.dense_Z())          # (n, 4r, 2d)
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
        mqq, mqp, mpq, mpp = state.Z
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


def _nac_factor(params: HKParams, potential, x, pvec, sign):
    """The NAC factor entering k~ic:

    nac = n2 + (q0 - x)^T R n1 + sign * i/hbar pvec . n1
    with n1 = -hbar^2 tau1/m, n2 = -hbar^2/2 sum_k tau2_k/m_k.
    sign = +1 at the initial point (q), -1 at the current point (Q).
    """
    inv_m = 1.0 / potential.masses()
    tau1 = potential.derivative_coupling_1st(x)
    tau2 = potential.derivative_coupling_2nd(x)
    n1 = -(hbar**2) * tau1 * inv_m[None, :]                 # (n, d)
    n2 = -(hbar**2) * 0.5 * torch.sum(tau2 * inv_m[None, :], dim=1)
    dq = params.q0[None, :] - x
    if params.R_diag is not None:
        core = n2 + torch.sum(dq * params.R_diag * n1, dim=1)
    else:
        core = n2 + _quad(dq, params.R, n1)
    return torch.complex(core, (sign / hbar) * torch.sum(pvec * n1, dim=1))


def _shifted_momentum(params: HKParams, p):
    """p0 + Gamma_0 [Gi+G0]^{-1} (p - p0)."""
    dp = p - params.p0[None, :]
    if params.shift_diag is not None:
        return params.p0[None, :] + dp * params.shift_diag
    return params.p0[None, :] + dp @ params.shift


def hk_batch_constants(params: HKParams, qi, pi, log_prob,
                       potential) -> BatchConstants:
    """Precompute everything that depends only on the initial conditions.
    Reads one scalar (the weight scale) back to the host."""
    n = qi.shape[0]
    logw = -(float(np.log(n)) + log_prob
             + params.dim * float(np.log(2.0 * np.pi * hbar)))
    log_scale = torch.mean(logw)
    logw_norm = logw - log_scale
    vi = overlap_vector(params.csoi0, qi, pi, params.q0, params.p0)
    # exponent parts of the *weighted* initial overlap: for trajectories far
    # in the tail, vi underflows while weight * vi is O(1/n) — the product
    # must live as a single fused exponent
    re_i, im_i = overlap_exponent_vector(params.csoi0, qi, pi,
                                         params.q0, params.p0)
    nacq = _nac_factor(params, potential, qi, _shifted_momentum(params, pi),
                       +1.0)
    return BatchConstants(qi=qi, pi=pi, log_prob=log_prob,
                          weight=torch.exp(logw_norm), logw_norm=logw_norm,
                          log_weight_scale=float(log_scale), vi=vi,
                          obs_re=re_i + logw_norm, obs_im=im_i, nacq=nacq)


def hk_autocorr_qp(params: HKParams, bc: BatchConstants, state: TrajState,
                   c_signed):
    """Per-trajectory *weighted* contribution to the autocorrelation
    function. The weight, both overlap exponents and the action phase are
    combined into one exponent before exponentiating, so tail trajectories
    whose raw overlap underflows still contribute exactly."""
    re_t, im_t = overlap_exponent_vector(params.csot0, state.q, state.p,
                                         params.q0, params.p0)
    total_re = re_t + bc.obs_re
    total_im = (bc.obs_im - im_t) + state.S / hbar
    fac = params.csot0.fac.conjugate() * params.csoi0.fac
    return fac * c_signed * torch.polar(torch.exp(total_re), total_im)


def hk_observables_qp(params: HKParams, bc: BatchConstants,
                      state: TrajState, c_signed, potential):
    """The per-trajectory contributions (cauto_qp, kic_qp), complex (n,)
    each, whose batch sums are C_auto(t) and k~ic(t)."""
    cauto_qp = hk_autocorr_qp(params, bc, state, c_signed)
    nacQ = _nac_factor(params, potential, state.q,
                       _shifted_momentum(params, state.p), -1.0)
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
    single trajectories would misstate the error. At float64 the plain sum
    is safe: |x_i| ~ 1e-23 at 60 modes, its square far above the range
    floor (the JAX package's factored (max, sum) form guards float32)."""
    if mode == "pairs":
        x_qp = x_qp.view(-1, 2).sum(dim=1)
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
    return (c_signed * torch.polar(torch.ones_like(state.S), state.S / hbar)
            * bc.vi * bc.weight)


def hk_log_coefficients(params: HKParams, bc: BatchConstants,
                        state: TrajState, c_signed):
    """log v_i of the fully weighted HK coefficients as two float64 tensors
    (log |v_i|, arg v_i): the range-safe form of `hk_coefficients` (the
    normalised weights alone span exp(+-O(100)) at many modes, while the
    combined exponent stays O(-log n) for every contributing trajectory)."""
    fac = params.csoi0.fac
    log_re = (torch.log(torch.abs(c_signed)) + bc.obs_re
              + float(np.log(abs(fac))) + bc.log_weight_scale)
    log_im = (torch.angle(c_signed) + state.S / hbar + bc.obs_im
              + float(np.angle(fac)))
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


def _hk_norm_block_term(ov, qi, pi, vi, qj, pj, vj):
    return torch.einsum("i,ij,j->", vi.conj(), overlap_matrix(ov, qi, pi, qj,
                                                              pj), vj)


def _hk_norm_log_block_term(ov, qi, pi, lri, lii, qj, pj, lrj, lij):
    """conj(v_i) <g_i|g_j> v_j of one block pair, each entry assembled as
    ONE exponent (log-coefficients + pair-overlap exponent + log fac):
    finite wherever the true pair term is."""
    re, im = overlap_exponent_matrix(ov, qi, pi, qj, pj)
    total_re = (lri[:, None] + lrj[None, :] + re
                + float(np.log(abs(ov.fac))))
    total_im = -lii[:, None] + lij[None, :] + im + float(np.angle(ov.fac))
    return torch.sum(torch.polar(torch.exp(total_re), total_im))


def pairwise_norm(ov: OverlapParams, q, p, v, block=None):
    """|psi| = sqrt(sum_ij v_i^* <g_i|g_j> v_j) from linear coefficients,
    by blocked accumulation over the Hermitian upper triangle. O(n^2):
    an opt-in convergence diagnostic."""
    if block is None:
        block = pair_block(q.shape[0], HK_PAIR_BYTES, q.device)
    return _sqrt_norm(blocked_pair_sum(_hk_norm_block_term, ov, (q, p, v),
                                       block))


def pairwise_norm_log(ov: OverlapParams, q, p, log_v, block=None,
                      sample_pairs=None, key=0):
    """|psi| from log-coefficients — the range-safe pairwise norm.

    With `sample_pairs`: the subsampled estimate (`subsampled_pair_sum`,
    at the largest block that divides n) as (norm, stderr), the stderr
    propagated through the square root."""
    n = q.shape[0]
    if block is None:
        block = pair_block(n, HK_PAIR_BYTES, q.device)
    arrays = (q, p, *log_v)
    if sample_pairs is not None:
        return _sqrt_norm(*subsampled_pair_sum(
            _hk_norm_log_block_term, ov, arrays, _divisor_block(n, block),
            sample_pairs=sample_pairs, key=key))
    return _sqrt_norm(blocked_pair_sum(_hk_norm_log_block_term, ov, arrays,
                                       block))


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
        return TrajState(q=obj.q[a:b], p=obj.p[a:b], Z=Z, S=obj.S[a:b])
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v[a:b]
        elif dataclasses.is_dataclass(v):
            v = _batch_rows(v, a, b)
        fields[f.name] = v
    return dataclasses.replace(obj, **fields)


def _cat_batches(parts):
    """The inverse of `_batch_rows` over consecutive sub-batches."""
    first = parts[0]
    if isinstance(first, TrajState):
        dim = 1 if first.diag_monodromy else 0
        return TrajState(q=torch.cat([x.q for x in parts]),
                         p=torch.cat([x.p for x in parts]),
                         Z=torch.cat([x.Z for x in parts], dim=dim),
                         S=torch.cat([x.S for x in parts]))
    fields = {}
    for f in dataclasses.fields(first):
        v = getattr(first, f.name)
        if isinstance(v, torch.Tensor):
            v = torch.cat([getattr(x, f.name) for x in parts])
        elif dataclasses.is_dataclass(v):
            v = _cat_batches([getattr(x, f.name) for x in parts])
        fields[f.name] = v
    return dataclasses.replace(first, **fields)


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
    """

    def __init__(self, Gamma_i, Gamma_t, device):
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
        self.last_energies = np.zeros(0)
        # sub-batch size of the time loop (0: the whole batch at once)
        self.micro_batch = 0
        self.sampling_method = "pseudo"

    def initial_conditions(self, q0, p0, Gamma_0, potential, ntraj=5000,
                           generator=None, normals=None,
                           sampling_method="pseudo"):
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
        """
        q0 = np.asarray(q0, dtype=np.float64)
        p0 = np.asarray(p0, dtype=np.float64)
        Gamma_0 = np.asarray(Gamma_0, dtype=np.float64)
        sampling = SamplingParams.create(q0, p0, Gamma_0, self.Gamma_i,
                                         self.device)
        self.sampling = sampling
        self.sampling_method = sampling_method
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
        hess = potential.local_expansion(qi[:1])[2]
        if not isinstance(hess, (ConstHessian, DenseHessian, DiagHessian)):
            raise NotImplementedError(
                "the port propagates the dense monodromy under ConstHessian "
                "or DenseHessian expansions and the diagonal monodromy under "
                f"DiagHessian ones; this potential gives "
                f"{type(hess).__name__}")
        self.state = TrajState.initial(
            qi, pi, diag_monodromy=isinstance(hess, DiagHessian))
        self.bc = self._make_batch_constants(qi, pi, log_prob, potential)
        self.tracker = self._make_trackers(self.state)
        self.ntraj = ntraj
        self.t = 0.0

    # -- hooks shared with the WM subclass -----------------------------------

    def _make_params(self, Gamma_0, q0, p0, sampling):
        """The constant parameter pack."""
        return build_hk_params(self.Gamma_i, self.Gamma_t, Gamma_0, q0, p0,
                               sampling.U, sampling.iGi0, self.device)

    def _make_batch_constants(self, qi, pi, log_prob, potential):
        """The per-batch constants of the sampled initial conditions."""
        return hk_batch_constants(self.params, qi, pi, log_prob, potential)

    def _make_trackers(self, state):
        """The branch-cut tracking state at the initial conditions."""
        return SignTracker.fresh(hk_prefactor_det(self.params, state))

    def _observe(self, state, tracker, potential, bc, m2_mode=False):
        """One step's observables: the tracker advanced to `state`, the
        (C_auto, k~ic) batch sums as 0-d device tensors, and their second
        moments (`second_moment`; None unless `m2_mode`)."""
        tracker = tracker.update(hk_prefactor_det(self.params, state))
        cauto_qp, kic_qp = hk_observables_qp(self.params, bc, state,
                                             tracker.sqrt(), potential)
        return (tracker, torch.sum(cauto_qp), torch.sum(kic_qp),
                *_moments(cauto_qp, kic_qp, m2_mode))

    def _micro_k(self, m2_mode):
        """The number of sub-batches of the time loop: ntraj / micro_batch
        when `micro_batch` is set, smaller than the batch and divides it;
        else 1 (with a warning where it does not divide)."""
        m, n = int(self.micro_batch or 0), self.ntraj
        if m <= 0 or n <= m:
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

    def _run(self, potential, dt, nt, chunk=None, progress=None,
             m2_mode=False):
        """The time loop: `nt` steps from the current state, in scan
        segments of at most `chunk` steps, each segment sub-batch by
        sub-batch under `micro_batch`. Returns the device tensors (cauto,
        kic, energies) of length nt and the second moments (2, nt) (None
        unless `m2_mode`); sub-batch sums and moments add, energies
        average.

        A `taylor_every` window (`eom.make_taylor_window`) restarts at the
        head of every segment, as the JAX package's scans do, so `chunk`
        is part of the result there; `progress`, if given, is called at
        the end of every segment (one host read per segment)."""
        every = int(getattr(potential, "taylor_every", 1) or 1)
        if every > 1:
            if getattr(potential, "hessian_eval", "stage") != "taylor":
                raise ValueError(
                    "taylor_every > 1 requires hessian_eval='taylor'")
            fresh, advance = make_taylor_window(potential, dt, every)
        else:
            step_map = None
            if not self.state.diag_monodromy:
                hess = potential.local_expansion(self.state.q[:1])[2]
                if isinstance(hess, ConstHessian):
                    step_map = const_step_map(hess, potential.masses(), dt)

            def fresh(state):
                return None

            def advance(state, carry):
                return (*rk4_step(state, potential, dt, step_map), carry)

        if chunk is None or chunk >= nt:
            segments = [nt]
        else:
            segments = [chunk] * (nt // chunk) + ([nt % chunk]
                                                   if nt % chunk else [])
        k, n = self._micro_k(m2_mode), self.ntraj
        rows = [(s * n // k, (s + 1) * n // k) for s in range(k)]
        bcs = ([self.bc] if k == 1
               else [_batch_rows(self.bc, a, b) for a, b in rows])
        cauto = torch.empty(k, nt, dtype=torch.complex128, device=self.device)
        kic = torch.empty(k, nt, dtype=torch.complex128, device=self.device)
        energies = torch.empty(k, nt, dtype=torch.float64, device=self.device)
        m2 = (torch.empty(2, k, nt, dtype=torch.float64, device=self.device)
              if m2_mode else None)
        state, tracker = self.state, self.tracker
        done = 0
        for seg in segments:
            parts = []
            for s, (a, b) in enumerate(rows):
                st, tr = ((state, tracker) if k == 1 else
                          (_batch_rows(state, a, b),
                           _batch_rows(tracker, a, b)))
                carry = fresh(st)
                for i in range(done, done + seg):
                    tr, cauto[s, i], kic[s, i], m2c, m2k = self._observe(
                        st, tr, potential, bcs[s], m2_mode)
                    if m2_mode:
                        m2[0, s, i], m2[1, s, i] = m2c, m2k
                    st, energies[s, i], carry = advance(st, carry)
                parts.append((st, tr))
            state, tracker = (parts[0] if k == 1 else
                              tuple(_cat_batches(list(x))
                                    for x in zip(*parts)))
            done += seg
            if progress is not None and chunk:
                progress(done, nt, complex(torch.sum(cauto[:, done - 1]))
                         * self.bc.weight_scale)
        self.state, self.tracker = state, tracker
        self.t += nt * float(dt)
        if k == 1:
            return cauto[0], kic[0], energies[0], (None if m2 is None
                                                   else m2[:, 0])
        return (cauto.sum(dim=0), kic.sum(dim=0), energies.mean(dim=0),
                None if m2 is None else m2.sum(dim=1))

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
        t_start = self.t
        cauto, kic, energies, m2 = self._run(potential, dt, nt, chunk,
                                             progress, m2_mode)
        cauto = cauto.cpu().numpy()
        kic = kic.cpu().numpy()
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

    def semiclassical_prefactor(self):
        """The sign-aligned HK prefactor C(t) at the current state, (n,)
        complex; advances the tracker to the state first (a no-op when it
        is already there)."""
        self.tracker = self.tracker.update(hk_prefactor_det(self.params,
                                                            self.state))
        return self.tracker.sqrt()

    def autocorrelation(self, energy0_es=0.0):
        """C(t) at the current state."""
        c = self.semiclassical_prefactor()
        cauto = torch.sum(hk_autocorr_qp(self.params, self.bc, self.state, c))
        return complex(cauto) * self.bc.weight_scale * self._phase(energy0_es)

    def ic_correlation(self, potential, energy0_es=0.0):
        """k~ic(t) at the current state."""
        c = self.semiclassical_prefactor()
        _, kic = hk_observables(self.params, self.bc, self.state, c,
                                potential)
        return complex(kic) * self.bc.weight_scale * self._phase(energy0_es)

    def coefficients(self):
        """The linear coefficients v_i, weight scale included; they
        over/underflow where the true magnitude does (`log_coefficients`
        is exact at any mode count)."""
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
        With `sample_pairs`: the subsampled estimate (norm, stderr)."""
        return pairwise_norm_log(self.params.csott, self.state.q,
                                 self.state.p, self._log_coefficients(),
                                 block=block, sample_pairs=sample_pairs,
                                 key=key)

    def wavefunction(self, x):
        """psi(x, t) on a grid x (nx, d), complex numpy (nx,), from
        log-coefficients with the exponent shift recombined on the host."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64,
                            device=self.device)
        psi, zmax = wavefunction_log(self.params.wf, self.state.q,
                                     self.state.p, self._log_coefficients(),
                                     x)
        return psi.cpu().numpy() * np.exp(zmax.cpu().numpy())

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
