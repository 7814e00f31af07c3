# coding: utf-8
"""Coherent-state overlaps of multidimensional frozen Gaussians

    <x|q,p,G> = (det(G)/pi^N)^{1/4}
                exp(-1/2 (x-q)^T G (x-q) + i/hbar p^T (x-q))

The port of `OverlapParams`, the overlap exponents and `overlap_vector`
of `semiclassical_tpu.coherent` — what the HK batch constants and the
per-step autocorrelation use. The spectral work on the constant width
matrices happens once on the host (`OverlapParams.create`); the device
functions are batched with the trajectory axis leading.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.units import hbar

__all__ = ["OverlapParams", "overlap_exponent_vector", "overlap_vector"]


@dataclass(frozen=True)
class OverlapParams:
    """Constants for evaluating <qi,pi,Gi|qj,pj,Gj> overlaps."""

    Gi_iGij_Gj: torch.Tensor  # (d, d)   Gi [Gi+Gj]^{-1} Gj
    iGij: torch.Tensor        # (d, d)   pseudo-inverse of Gi+Gj
    Gj_iGij: torch.Tensor     # (d, d)   Gj [Gi+Gj]^{-1}
    fac: complex              # normalisation prefactor
    rank: int
    # (3, d) stack of the three matrices' diagonals when all of them are
    # exactly diagonal (diagonal widths): the exponent quadratic forms
    # are then elementwise products and a mode sum. None otherwise.
    diag_w: torch.Tensor | None = None

    @staticmethod
    def create(Gi, Gj, device):
        Gi = np.asarray(Gi, dtype=np.float64)
        Gj = np.asarray(Gj, dtype=np.float64)
        if Gi.shape != Gj.shape:
            raise ValueError(
                "width matrices Gi and Gj have to have the same shape")
        ei, _ = linalg.sym_eigh(Gi)
        ej, _ = linalg.sym_eigh(Gj)
        ranki = int(np.count_nonzero(np.abs(ei) > linalg.ZERO))
        rankj = int(np.count_nonzero(np.abs(ej) > linalg.ZERO))
        if ranki != rankj:
            raise ValueError(
                "Gi and Gj have to have the same rank and null space.")
        detGi = np.prod(ei[np.abs(ei) > linalg.ZERO])
        detGj = np.prod(ej[np.abs(ej) > linalg.ZERO])

        Gij = Gi + Gj
        eij, Vij = linalg.sym_eigh(Gij)
        nz = np.abs(eij) > linalg.ZERO
        iGij = np.einsum("ij,j,kj->ik", Vij[:, nz], 1.0 / eij[nz], Vij[:, nz])
        detGij = np.prod(eij[nz])

        fac = np.sqrt(
            2.0**ranki * np.sqrt(detGi + 0j) * np.sqrt(detGj + 0j) / detGij
        )
        m1, m2, m3 = Gi @ iGij @ Gj, iGij, Gj @ iGij
        offdiag = max(float(np.abs(m - np.diag(np.diag(m))).max())
                      for m in (m1, m2, m3))
        diag_w = (np.stack([np.diag(m) for m in (m1, m2, m3)])
                  if offdiag == 0.0 else None)
        return OverlapParams.from_arrays(m1, m2, m3, complex(fac), ranki,
                                         device, diag_w=diag_w)

    @staticmethod
    def from_arrays(Gi_iGij_Gj, iGij, Gj_iGij, fac, rank, device,
                    diag_w=None):
        t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                   device=device)
        return OverlapParams(Gi_iGij_Gj=t(Gi_iGij_Gj), iGij=t(iGij),
                             Gj_iGij=t(Gj_iGij), fac=complex(fac),
                             rank=int(rank),
                             diag_w=None if diag_w is None else t(diag_w))


def _quad(x, A, y):
    """sum_ab x_na A_ab y_nb for batches x, y of shape (n, d)."""
    return torch.sum((x @ A) * y, dim=-1)


def overlap_exponent_vector(ov: OverlapParams, qi, pi, qj, pj):
    """(re, im) exponent parts of <qi(n),pi(n),Gi|qj,pj,Gj> for a batch of
    bra states qi, pi (n, d) and one ket qj, pj (d,)."""
    dq = qj[None, :] - qi
    dp = pj[None, :] - pi
    if ov.diag_w is not None:
        w1, w2, w3 = ov.diag_w
        re_part = (-0.5 * torch.sum(dq * w1 * dq, dim=-1)
                   - (0.5 / hbar**2) * torch.sum(dp * w2 * dp, dim=-1))
        im_part = (torch.sum(dq * w3 * dp, dim=-1) - dq @ pj) / hbar
        return re_part, im_part
    re_part = (-0.5 * _quad(dq, ov.Gi_iGij_Gj, dq)
               - (0.5 / hbar**2) * _quad(dp, ov.iGij, dp))
    im_part = (_quad(dq, ov.Gj_iGij, dp) - dq @ pj) / hbar
    return re_part, im_part


def overlap_vector(ov: OverlapParams, qi, pi, qj, pj):
    """<qi(n),pi(n),Gi|qj,pj,Gj> for a batch of bra states and one ket,
    complex (n,)."""
    re, im = overlap_exponent_vector(ov, qi, pi, qj, pj)
    return ov.fac * torch.polar(torch.exp(re), im)
