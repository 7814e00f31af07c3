# coding: utf-8
"""The port's batched-determinant kernel K1 (semiclassical_tpu_torch.ops.det)
against the JAX package.

On the CPU the port runs the kernel's plain PyTorch version (the same
unpivoted LU in the same pivot order). It is held against

* JAX's `linalg.batched_det` at complex128 (on the CPU that is LAPACK's
  pivoted det — the two differ only in rounding order, so rtol 1e-10 on
  well-conditioned matrices), and
* the Pallas kernel itself (`pallas_batched_det_lanes`, which always
  computes in complex64) in interpret mode, at complex64 and 1e-4 relative,
  the tolerance of tests/test_linalg.py.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import linalg as jax_linalg
from semiclassical_tpu.ops import pallas_batched_det_lanes
from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.ops import det


def _well_conditioned(rng, n, r):
    return (np.eye(r)[None] + 0.3 * (rng.standard_normal((n, r, r))
                                     + 1j * rng.standard_normal((n, r, r)))
            / np.sqrt(r))


@pytest.mark.parametrize("r", [2, 6, 12, 45])
def test_plain_c128_matches_jax_batched_det(r):
    A = _well_conditioned(np.random.default_rng(r), 20, r)
    ref = np.asarray(jax_linalg.batched_det(jnp.asarray(A)))
    got = det.batched_det_lu_plain(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


@pytest.mark.parametrize("r", [6, 12])
def test_plain_c64_matches_pallas_lanes_interpret(r):
    # n = 20 is deliberately not a multiple of the Pallas tile
    A = _well_conditioned(np.random.default_rng(100 + r), 20, r).astype(
        np.complex64)
    ref = np.asarray(pallas_batched_det_lanes(jnp.asarray(A), tile=16))
    got = det.batched_det_lu_plain(torch.from_numpy(A)).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() / np.abs(ref).min() < 1e-4


def test_cpu_tensor_takes_the_plain_version():
    A = torch.from_numpy(_well_conditioned(np.random.default_rng(3), 9, 6))
    before = det.LAUNCHES
    got = linalg.batched_det(A)
    assert det.LAUNCHES == before
    assert torch.equal(got, det.batched_det_lu_plain(A))


def test_other_devices_raise():
    A = torch.empty((4, 6, 6), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        det.batched_det(A)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("r", [1, 6, 64])
def test_arg_check_accepts(dtype, r):
    det.check_det_args(torch.zeros((3, r, r), dtype=dtype))


@pytest.mark.parametrize("A, match", [
    (torch.zeros((3, 65, 65), dtype=torch.complex128), "r <= 64"),
    (torch.zeros((3, 6, 6), dtype=torch.float64), "complex128 or complex64"),
    (torch.zeros((3, 6, 7), dtype=torch.complex128)[:, :, :6], "contiguous"),
    (torch.zeros((6, 6), dtype=torch.complex128), "batch"),
    (torch.zeros((3, 6, 5), dtype=torch.complex128), "batch"),
], ids=["r65", "float64", "non-contiguous", "2d", "non-square"])
def test_arg_check_rejects(A, match):
    with pytest.raises(ValueError, match=match):
        det.check_det_args(A)

