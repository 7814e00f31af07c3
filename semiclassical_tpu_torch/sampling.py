# coding: utf-8
"""Monte-Carlo sampling of initial phase-space conditions.

The probability for sampling the phase-space point (qi, pi) is proportional
to |<qi,pi,Gamma_i|q0,p0,Gamma_0>|^2. The singular covariance is factorised
once on the host through eigendecompositions of Gamma_i + Gamma_0
(momentum block) and Gamma_i [Gamma_i+Gamma_0]^{-1} Gamma_0 (position
block); zero-frequency modes are excluded from sampling. The port of
`SamplingParams` and the "pseudo" method of `sample_initial_conditions` in
`semiclassical_tpu.sampling`: the standard normals come from an explicit
`torch.Generator` on the device, or are passed in (`normals=`) so that two
implementations can be fed the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg

__all__ = ["SamplingParams", "sample_initial_conditions"]


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


def sample_initial_conditions(params: SamplingParams, ntraj: int,
                              generator=None, normals=None):
    """Draw `ntraj` initial phase-space points and their sampling densities.

    The standard normals are drawn from `generator` (a `torch.Generator` on
    the parameters' device), or taken from `normals`, an (ntraj, 2 rank)
    tensor.

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
        x = torch.randn(shape, generator=generator, dtype=params.iLz.dtype,
                        device=params.iLz.device)
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
