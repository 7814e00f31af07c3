# coding: utf-8
"""Herman-Kluk (HK) semiclassical IVR propagator.

[HK] E. Kluk, M. Herman, H. Davis, J. Chem. Phys. 84, 326 (1986)

The port of `semiclassical_tpu.propagation.hk` on two paths:

* the dense-prefactor path (molecular harmonic PES, any width matrix):
  `HKParams` / `BatchConstants` are precomputed once: the null-space
  projector U of singular width matrices is folded into the constant left
  and right factors of the prefactor matrix, so the per-step work is two
  real matmuls over the stacked monodromy plus one batched (n, r, r)
  complex determinant — the CUDA kernel of `ops.det` on the card;
* the separable path (model potentials, diagonal Hessians and diagonal
  widths): the monodromy is kept in the diagonal representation, the
  prefactor matrix is diagonal and its determinant a log-space product
  over modes, and the overlap exponents and NAC forms are elementwise —
  no matmul and no determinant kernel in the step;
* everything that depends only on the initial phase-space points (the
  overlap <qi,pi|phi(0)>, the Monte-Carlo log-weights, the initial-point
  NAC factor of k~ic) is computed once per batch;
* `propagate` runs the time loop in Python with every per-step result
  written into preallocated device tensors — no host synchronisation per
  step. C(t), k~ic(t) and the batch-mean energies come to the host once per
  call, where the energy-conservation guard and the separable phases apply.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.coherent import (OverlapParams,
                                              overlap_exponent_vector,
                                              overlap_vector)
from semiclassical_tpu_torch.potentials.base import ConstHessian, DiagHessian
from semiclassical_tpu_torch.propagation.eom import const_step_map, rk4_step
from semiclassical_tpu_torch.propagation.state import SignTracker, TrajState
from semiclassical_tpu_torch.sampling import (SamplingParams,
                                              sample_initial_conditions)
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

    @property
    def factors_diag(self):
        return self.diag_K is not None

    @staticmethod
    def from_factors(Lt_s, Lt_i, Ri_s, Ri_i, q0, p0, G0, iGi0, R,
                     csoi0, csot0, device, diag=None):
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
            diag_K=t(diag_K), **{k: t(v) for k, v in diag.items()})


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
        device=device)


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


def hk_observables(params: HKParams, bc: BatchConstants, state: TrajState,
                   c_signed, potential):
    """(C_auto(t), k~ic(t)) reduced over the trajectory batch as 0-d device
    tensors, *without* the excited-state dynamical phase exp(i t E0/hbar)
    and the weight scale — both are applied on the host."""
    cauto_qp = hk_autocorr_qp(params, bc, state, c_signed)
    nacQ = _nac_factor(params, potential, state.q,
                       _shifted_momentum(params, state.p), -1.0)
    kic_qp = (1.0 / hbar**2) * nacQ * bc.nacq * cauto_qp
    return torch.sum(cauto_qp), torch.sum(kic_qp)


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
    `propagate` runs `nt` steps and returns C(t) and k~ic(t), `step`
    advances one step.
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

    def initial_conditions(self, q0, p0, Gamma_0, potential, ntraj=5000,
                           generator=None, normals=None):
        """Sample initial phase-space points and initialise the state.

        Parameters
        ----------
        q0, p0 : (d,) center and momentum of the initial wavepacket
        Gamma_0 : (d, d) width matrix of the initial wavepacket
        potential : the PES; its Hessian operator decides the monodromy
            representation (a `ConstHessian` gives the dense one, a
            `DiagHessian` the diagonal one)
        ntraj : number of trajectories
        generator : torch.Generator on the propagator's device
        normals : optional (ntraj, 2 rank) standard normals used in place
            of the generator's draws
        """
        q0 = np.asarray(q0, dtype=np.float64)
        p0 = np.asarray(p0, dtype=np.float64)
        Gamma_0 = np.asarray(Gamma_0, dtype=np.float64)
        sampling = SamplingParams.create(q0, p0, Gamma_0, self.Gamma_i,
                                         self.device)
        self.params = self._make_params(Gamma_0, q0, p0, sampling)
        logger.info("== Initial Conditions ==")
        logger.info(f"number of dimensions   :  {self.params.dim}")
        logger.info(f"zero dimensions        :  "
                    f"{self.params.dim - self.params.rank}")
        logger.info(f"number of trajectories :  {ntraj}")

        qi, pi, log_prob = sample_initial_conditions(
            sampling, ntraj, generator=generator, normals=normals)
        hess = potential.local_expansion(qi[:1])[2]
        if not isinstance(hess, (ConstHessian, DiagHessian)):
            raise NotImplementedError(
                "the port propagates the dense monodromy of a constant-"
                "Hessian PES and the diagonal monodromy of a separable PES; "
                f"this potential gives {type(hess).__name__} (a per-"
                "trajectory dense Hessian, as sGDML's, is not ported yet)")
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

    def _observe(self, state, tracker, potential):
        """One step's observables: the tracker advanced to `state` and the
        (C_auto, k~ic) batch sums as 0-d device tensors."""
        tracker = tracker.update(hk_prefactor_det(self.params, state))
        cauto, kic = hk_observables(self.params, self.bc, state,
                                    tracker.sqrt(), potential)
        return tracker, cauto, kic

    def _run(self, potential, dt, nt, chunk=None, progress=None):
        """The time loop: `nt` steps from the current state. Returns the
        device tensors (cauto, kic, energies) of length nt."""
        step_map = None
        if not self.state.diag_monodromy:
            hess = potential.local_expansion(self.state.q[:1])[2]
            step_map = const_step_map(hess, potential.masses(), dt)
        cauto = torch.empty(nt, dtype=torch.complex128, device=self.device)
        kic = torch.empty(nt, dtype=torch.complex128, device=self.device)
        energies = torch.empty(nt, dtype=torch.float64, device=self.device)
        state, tracker = self.state, self.tracker
        for i in range(nt):
            tracker, cauto[i], kic[i] = self._observe(state, tracker,
                                                      potential)
            state, energies[i] = rk4_step(state, potential, dt, step_map)
            if progress is not None and chunk and (i + 1) % chunk == 0:
                progress(i + 1, nt,
                         complex(cauto[i]) * self.bc.weight_scale)
        self.state, self.tracker = state, tracker
        self.t += nt * float(dt)
        return cauto, kic, energies

    def propagate(self, potential, dt, nt, energy0_es=0.0, check_energy=True,
                  chunk=None, progress=None):
        """Run `nt` steps.

        Returns (autocorrelation (nt,), ic_correlation (nt,)) as numpy
        arrays sampled at t0, t0 + dt, ..., t0 + (nt-1) dt; the state
        advances by nt steps. `progress`, if given, is called every `chunk`
        steps with (steps_done, nt, C(t) at the last step) — the one host
        read per chunk. The per-step batch-mean energies of the run are
        kept in `self.last_energies`.
        """
        t_start = self.t
        cauto, kic, energies = self._run(potential, dt, nt, chunk, progress)
        cauto = cauto.cpu().numpy()
        kic = kic.cpu().numpy()
        self.last_energies = energies.cpu().numpy()
        if check_energy:
            check_energy_conservation(self.last_energies)
        ts = t_start + float(dt) * np.arange(nt)
        phase = np.exp(1j / hbar * energy0_es * ts)
        scale = self.bc.weight_scale
        return cauto * scale * phase, kic * scale * phase

    def step(self, potential, dt):
        """Advance one time step t -> t + dt (updates the sign tracker)."""
        self._run(potential, dt, 1)
