# coding: utf-8
"""The port's block-per-matrix determinant kernel K4
(semiclassical_tpu_torch.ops.det_block) and the size rule of
`linalg.batched_det` on the CPU.

On the CPU the wrapper runs the plain PyTorch version of the kernel's
unpivoted LU (the one K1 shares, `ops.det.batched_det_lu_plain`). It is
held against

* the Pallas kernel K4 replaces (`pallas_batched_det`, which always
  computes in complex64) in interpret mode, at complex64 and 1e-4
  relative, the tolerance of tests/test_ops.py, with a ragged n that is
  not a multiple of the Pallas tile, at r = 6 and at coumarin's r = 45;
* LAPACK's pivoted determinant (numpy) at complex128, 1e-10 relative on
  well-conditioned matrices I + 0.3 noise / sqrt(r) (the two differ only
  in rounding order).

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu.ops import pallas_batched_det
from semiclassical_tpu_torch import linalg, ops
from semiclassical_tpu_torch.ops import det, det_block


def _well_conditioned(rng, n, r):
    return (np.eye(r)[None] + 0.3 * (rng.standard_normal((n, r, r))
                                     + 1j * rng.standard_normal((n, r, r)))
            / np.sqrt(r))


@pytest.mark.parametrize("r", [6, 45])
def test_plain_c64_matches_pallas_interpret(r):
    A = _well_conditioned(np.random.default_rng(200 + r), 20, r).astype(
        np.complex64)
    ref = np.asarray(pallas_batched_det(jnp.asarray(A), tile=16))
    got = det_block.batched_det_block(torch.from_numpy(A)).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() / np.abs(ref).min() < 1e-4


@pytest.mark.parametrize("r", [33, 45, 64])
def test_plain_c128_matches_lapack(r):
    A = _well_conditioned(np.random.default_rng(r), 16, r)
    got = det_block.batched_det_block(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.linalg.det(A), rtol=1e-10, atol=0)


def test_plain_version_is_k1s():
    assert det_block.batched_det_lu_plain is det.batched_det_lu_plain
    assert det_block.MAX_R == det.MAX_R == 64


def test_cpu_tensor_takes_the_plain_version():
    A = torch.from_numpy(_well_conditioned(np.random.default_rng(3), 9, 45))
    before = ops.launch_counts()
    got = det_block.batched_det_block(A)
    assert ops.launch_counts() == before
    assert torch.equal(got, det.batched_det_lu_plain(A))


def test_other_devices_raise():
    A = torch.empty((4, 45, 45), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        det_block.batched_det_block(A)


@pytest.mark.parametrize("r, kernel", [(1, "K1"), (6, "K1"), (16, "K1"),
                                       (17, "K1"), (27, "K1"), (28, "K4"),
                                       (32, "K4"), (33, "K4"), (45, "K4"),
                                       (64, "K4")])
def test_size_rule(monkeypatch, r, kernel):
    """`linalg.batched_det` sends r <= DET_WARP_MAX_R = 27 to K1's wrapper
    and 27 < r <= 64 to K4's, whatever the device."""
    calls = []
    monkeypatch.setattr(det, "batched_det",
                        lambda A: calls.append("K1") or A[:, 0, 0])
    monkeypatch.setattr(det_block, "batched_det_block",
                        lambda A: calls.append("K4") or A[:, 0, 0])
    assert linalg.DET_WARP_MAX_R == 27
    linalg.batched_det(torch.ones((3, r, r), dtype=torch.complex128))
    assert calls == [kernel]
