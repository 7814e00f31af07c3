# coding: utf-8
"""Tests of the port's CUDA kernels that need an NVIDIA GPU (marker
`cuda`; each skips where there is no card).

This file imports neither jax nor semiclassical_tpu, so that it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

K1 (`ops.det.batched_det`, csrc/det_lu.cu), K2 and K3
(`ops.gj.batched_det_solve_gj` / `batched_det_inv_gj`, csrc/gj_det.cu) are
held against their plain PyTorch versions on the same inputs: 1e-12
relative in complex128 and 1e-5 in complex64 (rounding-order differences
of the same elimination, FMA contraction included), on well-conditioned
matrices I + 0.3 noise/sqrt(r).
"""

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch.ops import det, gj

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _well_conditioned(n, r, dtype, device, seed):
    rng = np.random.default_rng(seed)
    A = (np.eye(r)[None] + 0.3 * (rng.standard_normal((n, r, r))
                                  + 1j * rng.standard_normal((n, r, r)))
         / np.sqrt(r))
    return torch.from_numpy(A).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype, r, n, rtol", [
    (torch.complex128, 6, 1000, 1e-12), (torch.complex64, 6, 1000, 1e-5),
    (torch.complex128, 1, 33, 1e-12), (torch.complex128, 45, 257, 1e-12),
    (torch.complex128, 64, 100, 1e-12), (torch.complex64, 64, 100, 1e-5)])
def test_kernel_matches_plain(card, dtype, r, n, rtol):
    A = _well_conditioned(n, r, dtype, card, seed=r)
    before = det.LAUNCHES
    got = det.batched_det(A)
    torch.cuda.synchronize()
    assert det.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    ref = det.batched_det_lu_plain(A)
    assert float(((got - ref).abs() / ref.abs()).max()) <= rtol


def test_empty_batch_launches_nothing(card):
    before = det.LAUNCHES
    got = det.batched_det(torch.empty((0, 6, 6), dtype=torch.complex128,
                                      device=card))
    assert got.shape == (0,) and det.LAUNCHES == before


@pytest.mark.parametrize("make", [
    lambda d: torch.zeros((4, 65, 65), dtype=torch.complex128, device=d),
    lambda d: torch.zeros((4, 6, 7), dtype=torch.complex128, device=d)[:, :, :6],
    lambda d: torch.zeros((4, 6, 6), dtype=torch.float64, device=d),
], ids=["r65", "non-contiguous", "float64"])
def test_wrapper_raises_on_card(card, make):
    before = det.LAUNCHES
    with pytest.raises(ValueError):
        det.batched_det(make(card))
    assert det.LAUNCHES == before


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dtype, m, k, n, rtol", [
    (torch.complex128, 6, 12, 1000, 1e-12), (torch.complex64, 6, 12, 1000, 1e-5),
    (torch.complex128, 6, 5, 1000, 1e-12), (torch.complex128, 1, 1, 33, 1e-12),
    (torch.complex128, 60, 120, 64, 1e-12), (torch.complex128, 64, 128, 40, 1e-12),
    (torch.complex64, 45, 45, 100, 1e-5)])
def test_solve_kernel_matches_plain(card, dtype, m, k, n, rtol):
    A = _well_conditioned(n, m, dtype, card, seed=m)
    B = _well_conditioned(n, max(m, k), dtype, card, seed=k)[:, :m, :k]
    B = B.contiguous()
    before = gj.LAUNCHES["det_solve"]
    det, sol = gj.batched_det_solve_gj(A, B)
    torch.cuda.synchronize()
    assert gj.LAUNCHES["det_solve"] == before + 1
    assert det.shape == (n,) and sol.shape == (n, m, k)
    det_p, sol_p = gj.batched_det_solve_gj_plain(A, B)
    assert float(((det - det_p).abs() / det_p.abs()).max()) <= rtol
    assert _rel(sol, sol_p) <= rtol


@pytest.mark.parametrize("dtype, m, n, rtol", [
    (torch.complex128, 12, 1000, 1e-12), (torch.complex64, 12, 1000, 1e-5),
    (torch.complex128, 6, 1000, 1e-12), (torch.complex128, 1, 33, 1e-12),
    (torch.complex128, 60, 64, 1e-12), (torch.complex128, 64, 40, 1e-12)])
def test_inv_kernel_matches_plain(card, dtype, m, n, rtol):
    A = _well_conditioned(n, m, dtype, card, seed=m)
    before = gj.LAUNCHES["det_inv"]
    det, inv = gj.batched_det_inv_gj(A)
    torch.cuda.synchronize()
    assert gj.LAUNCHES["det_inv"] == before + 1
    det_p, inv_p = gj.batched_det_inv_gj_plain(A)
    assert float(((det - det_p).abs() / det_p.abs()).max()) <= rtol
    assert _rel(inv, inv_p) <= rtol


@pytest.mark.parametrize("make", [
    lambda d: (torch.zeros((4, 65, 65), dtype=torch.complex128, device=d),
               torch.zeros((4, 65, 2), dtype=torch.complex128, device=d)),
    lambda d: (torch.zeros((4, 64, 64), dtype=torch.complex128, device=d),
               torch.zeros((4, 64, 129), dtype=torch.complex128, device=d)),
    lambda d: (torch.zeros((4, 6, 6), dtype=torch.complex128, device=d),
               torch.zeros((4, 6, 5), dtype=torch.complex128)),
], ids=["m65", "width193", "mixed-devices"])
def test_gj_wrappers_raise_on_card(card, make):
    A, B = make(card)
    before = dict(gj.LAUNCHES)
    with pytest.raises(ValueError):
        gj.batched_det_solve_gj(A, B)
    if A.shape[1] > gj.MAX_M:
        with pytest.raises(ValueError):
            gj.batched_det_inv_gj(A)
    assert gj.LAUNCHES == before
