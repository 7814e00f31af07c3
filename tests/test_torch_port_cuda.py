# coding: utf-8
"""Tests of the port's CUDA kernels that need an NVIDIA GPU (marker
`cuda`; each skips where there is no card).

This file imports neither jax nor semiclassical_tpu, so that it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

K1 (`ops.det.batched_det`, csrc/det_lu.cu) is held against its plain
PyTorch version on the same inputs: 1e-12 relative in complex128 and 1e-5
in complex64 (rounding-order differences of the same elimination, FMA
contraction included), on well-conditioned matrices I + 0.3 noise/sqrt(r).
"""

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch.ops import det

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
