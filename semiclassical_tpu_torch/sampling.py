# coding: utf-8
"""Monte-Carlo sampling of initial phase-space conditions.

The probability for sampling the phase-space point (qi, pi) is proportional
to |<qi,pi,Gamma_i|q0,p0,Gamma_0>|^2. The singular covariance is factorised
once on the host through eigendecompositions of Gamma_i + Gamma_0
(momentum block) and Gamma_i [Gamma_i+Gamma_0]^{-1} Gamma_0 (position
block); zero-frequency modes are excluded from sampling. The port of
`semiclassical_tpu.sampling`: the standard normals come from an explicit
`torch.Generator` on the device ("pseudo", and the "antithetic" pairs), from
scrambled Sobol' points whose scramble seed the generator draws ("sobol"),
or are passed in (`normals=`) so that two implementations can be fed the
same draws. `sampling_statistics` compares the sample moments with the
analytic ones in float64.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg, profiling

logger = logging.getLogger(__name__)

__all__ = ["SamplingParams", "SAMPLING_METHODS", "standard_normals",
           "scramble_seed", "sample_initial_conditions",
           "sampling_statistics", "log_sampling_statistics"]

SAMPLING_METHODS = ("pseudo", "antithetic", "sobol")


@dataclass(frozen=True)
class SamplingParams:
    """Host-precomputed factorisation of the sampling distribution:
    cov^{-1} = Lz Lz^T with Lz = blockdiag(Lq, Lp); sampling transforms
    standard normals x via z = z0 + x Lz^{-1}."""

    z0: torch.Tensor        # (2 d,)          phase-space center (q0, p0)
    iLz: torch.Tensor       # (2 rank, 2 d)   pseudo-inverse Lz^{-1}
    log_detLz: float        # log pseudo-determinant of Lz
    U: np.ndarray           # (d, rank) non-zero subspace of Gamma_i + Gamma_0
    iGi0: np.ndarray        # (d, d)    pseudo-inverse of Gamma_i + Gamma_0
    dim: int
    rank: int

    @staticmethod
    def create(q0, p0, Gamma_0, Gamma_i, device):
        q0 = np.asarray(q0, dtype=np.float64)
        p0 = np.asarray(p0, dtype=np.float64)
        G0 = np.asarray(Gamma_0, dtype=np.float64)
        Gi = np.asarray(Gamma_i, dtype=np.float64)
        if G0.shape != Gi.shape:
            raise ValueError(
                "width parameter matrix Gamma_0 has wrong dimensions")
        if not linalg.is_symmetric_non_negative(G0):
            raise ValueError(
                "Gamma_0 has to be symmetric and positive semi-definite.")
        d = q0.shape[0]

        Gi0 = G0 + Gi
        wp, Vp = linalg.sym_eigh(Gi0)
        nzp = wp > linalg.ZERO
        U = Vp[:, nzp]
        iGi0 = np.einsum("ij,j,kj->ik", Vp[:, nzp], 1.0 / wp[nzp], Vp[:, nzp])
        # 2 [Gi+G0]^{-1} = Lp Lp^T; pseudo-inverse Lp^{-1}
        iLp = np.einsum("i,ji->ij", np.sqrt(wp[nzp] / 2.0), Vp[:, nzp])

        # 2 Gi [Gi+G0]^{-1} G0 = Lq Lq^T; pseudo-inverse Lq^{-1}
        wq, Vq = linalg.sym_eigh(Gi @ iGi0 @ G0)
        nzq = wq > linalg.ZERO
        iLq = np.einsum("i,ji->ij", 1.0 / np.sqrt(2.0 * wq[nzq]), Vq[:, nzq])

        if np.count_nonzero(nzp) != np.count_nonzero(nzq):
            raise ValueError(
                "number of non-zero modes for sampling of positions and "
                "momenta have to be the same")
        rank = int(np.count_nonzero(nzp))

        # blockdiag pseudo-inverse and log pseudo-determinant of Lz (log
        # space: the product of per-mode ratios under/overflows in many
        # dimensions)
        iLz = np.zeros((2 * rank, 2 * d))
        iLz[:rank, :d] = iLq
        iLz[rank:, d:] = iLp
        log_detLz = float(np.sum(
            np.log(2.0) + 0.5 * (np.log(wq[nzq]) - np.log(wp[nzp]))))
        return SamplingParams.from_arrays(np.concatenate([q0, p0]), iLz,
                                          log_detLz, U, iGi0, d, rank, device)

    @staticmethod
    def from_arrays(z0, iLz, log_detLz, U, iGi0, dim, rank, device):
        t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                   device=device)
        return SamplingParams(z0=t(z0), iLz=t(iLz), log_detLz=float(log_detLz),
                              U=np.asarray(U, dtype=np.float64),
                              iGi0=np.asarray(iGi0, dtype=np.float64),
                              dim=int(dim), rank=int(rank))


def _gaussian(shape, generator, dtype, device):
    """i.i.d. standard normals of `shape` from `generator`."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def scramble_seed(generator):
    """The Sobol' scramble seed of a batch, drawn from `generator` (an int
    in [0, 2^31 - 1), as the JAX package draws it from its key)."""
    device = None if generator is None else generator.device
    return int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=device))


def standard_normals(params: SamplingParams, ntraj: int, method="pseudo",
                     generator=None, seed=None):
    """(ntraj, 2 rank) standard-normal draws for the sampling transform.

    method:
    * "pseudo"     — i.i.d. draws from `generator`;
    * "antithetic" — ntraj/2 i.i.d. draws and their negations, interleaved
                     so that each +-pair occupies adjacent rows (a pair stays
                     together under any even-sized contiguous split); the
                     Gaussian density is even, so the estimator stays
                     unbiased while every odd-in-x error component cancels
                     within each pair. Raises on an odd ntraj;
    * "sobol"      — scrambled Sobol' points (host-side `scipy.stats.qmc`)
                     through the inverse normal CDF; the scramble seed is
                     `seed` if given, else drawn from `generator`, so
                     independent generators give independent randomisations
                     and the estimator is unbiased. Best balanced at a
                     power-of-two ntraj (a warning otherwise).
    """
    shape = (ntraj, 2 * params.rank)
    dtype, device = params.iLz.dtype, params.iLz.device
    if method == "pseudo":
        return _gaussian(shape, generator, dtype, device)
    if method == "antithetic":
        if ntraj % 2:
            raise ValueError(f"antithetic sampling needs an even number of "
                             f"trajectories, got {ntraj}")
        half = _gaussian((ntraj // 2, shape[1]), generator, dtype, device)
        return torch.stack([half, -half], dim=1).reshape(shape)
    if method == "sobol":
        from scipy.special import ndtri
        from scipy.stats import qmc
        if seed is None:
            seed = scramble_seed(generator)
        sampler = qmc.Sobol(d=shape[1], scramble=True, seed=int(seed))
        m = ntraj.bit_length() - 1
        if ntraj == 1 << m:
            u = sampler.random_base2(m)
        else:
            logger.warning(f"sobol sampling with non-power-of-two "
                           f"ntraj={ntraj}: balance properties degrade")
            u = sampler.random(ntraj)
        # the scrambled points lie in [0, 1); clip away an exact 0 before
        # the inverse CDF (ndtri(0) = -inf)
        u = np.clip(u, 1e-16, 1.0 - 1e-16)
        return torch.tensor(ndtri(u), dtype=dtype, device=device)
    raise ValueError(f"unknown sampling method {method!r} "
                     "(expected 'pseudo', 'antithetic' or 'sobol')")


def sample_initial_conditions(params: SamplingParams, ntraj: int,
                              generator=None, normals=None):
    """Draw `ntraj` initial phase-space points and their sampling densities.

    The standard normals are drawn from `generator` (a `torch.Generator`
    on the parameters' device), or taken from `normals`, an (ntraj,
    2 rank) tensor (`standard_normals` draws them by method).

    Returns
    -------
    q : (ntraj, d) initial positions
    p : (ntraj, d) initial momenta
    log_prob : (ntraj,)  log of the sampling density log P(qi, pi)

    The density keeps the 1/(2 pi)^dim convention (full dim, not rank): the
    same factor appears in the phase-space volume element of every
    observable and cancels. It is returned in log space, where it stays
    O(100) while P itself spans hundreds of orders of magnitude.
    """
    d = params.dim
    shape = (ntraj, 2 * params.rank)
    if normals is None:
        x = standard_normals(params, ntraj, "pseudo", generator)
    else:
        x = torch.as_tensor(normals, dtype=params.iLz.dtype,
                            device=params.iLz.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"normals must have shape {shape}, "
                             f"got {tuple(x.shape)}")
    z = params.z0[None, :] + x @ params.iLz                 # (n, 2 d)
    q, p = z[:, :d], z[:, d:]
    log_prob = (params.log_detLz - d * np.log(2.0 * np.pi)
                - 0.5 * torch.sum(x * x, dim=1))
    return q, p, log_prob


def sampling_statistics(params: SamplingParams, q, p):
    """Deviation of the sample moments from the analytic distribution.

    The sampled points are z = z0 + x iLz with x ~ N(0, 1), so E[z] = z0
    and cov(z) = iLz^T iLz (singular on the zero modes, which are never
    sampled). Returns the largest deviations in standard-deviation units —
    mean deviation over sigma_i, covariance deviation over sigma_i sigma_j,
    zero modes skipped — as two floats from one host read. A healthy
    sampler sits at ~sqrt(2/ntraj) whatever the mode widths. The whole
    batch enters, in float64 (the JAX package's float32 covariance product
    is a TPU shortcut; the two differ by ~1e-6).
    """
    z = torch.cat([q, p], dim=1).to(torch.float64)
    n = z.shape[0]
    mean = torch.mean(z, dim=0)
    dz = z - mean[None, :]
    cov = (dz.T @ dz) / max(n - 1, 1)
    iLz = params.iLz.to(torch.float64)
    ana_cov = iLz.T @ iLz
    sigma = torch.sqrt(torch.diagonal(ana_cov))
    live = sigma > 0.0
    scale = torch.where(live, sigma, torch.ones_like(sigma))
    zero = torch.zeros((), dtype=torch.float64, device=z.device)
    mean_dev = torch.max(torch.where(live, torch.abs(mean - params.z0), zero)
                         / scale)
    pair_live = live[:, None] & live[None, :]
    cov_dev = torch.max(torch.where(pair_live, torch.abs(cov - ana_cov), zero)
                        / (scale[:, None] * scale[None, :]))
    both = profiling.to_host(torch.stack([mean_dev, cov_dev]))
    return float(both[0]), float(both[1])


def log_sampling_statistics(params: SamplingParams, q, p):
    """Log the two `sampling_statistics` lines; returns the values."""
    mean_dev, cov_dev = sampling_statistics(params, q, p)
    logger.info(f"max |<z> - z0| / sigma           :  {mean_dev:.6f}")
    logger.info(f"max |cov(z) - analytic| / sigma2 :  {cov_dev:.6f}")
    return mean_dev, cov_dev
