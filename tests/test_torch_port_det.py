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

K1's size rule (`det.det_variant`: which kernel of csrc/det_lu.cu a size
takes) is a plain function and is walked here for every r against the
sizes that file compiles its rows kernel for.

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_port_cuda.py.
"""

import pathlib
import re

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


# both sides of the rows kernel's limit (16 | 17), of 8 | 9 and of the rule
# of `linalg.batched_det` (DET_WARP_MAX_R | + 1)
@pytest.mark.parametrize("r", [8, 9, 16, 17, linalg.DET_WARP_MAX_R - 1,
                               linalg.DET_WARP_MAX_R,
                               linalg.DET_WARP_MAX_R + 1])
def test_plain_c128_matches_lapack_at_the_rules_edges(r):
    A = _well_conditioned(np.random.default_rng(300 + r), 11, r)
    got = det.batched_det_lu_plain(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.linalg.det(A), rtol=1e-10, atol=0)


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



def _compiled(source, macro):
    """The argument lists of the uses of `macro` in a csrc file (its
    definition, which names its parameters, is not one)."""
    text = (pathlib.Path(det.__file__).resolve().parents[1] / "csrc"
            / source).read_text()
    return [tuple(int(x) for x in args.split(","))
            for args in re.findall(macro + r"\(([0-9, ]+)\)", text)]


@pytest.mark.parametrize("r, kind", [(1, "rows"), (6, "rows"), (8, "rows"),
                                     (9, "rows"), (16, "rows"), (17, "warp"),
                                     (45, "warp"), (64, "warp")])
def test_det_variant(r, kind):
    assert det.det_variant(r) == kind
    assert det.ROWS_MAX_R == 16 and det.LAYOUT_CODES == {"warp": 0, "rows": 1}


def test_det_variant_covers_every_size():
    """Every r K1 takes gets a kernel that csrc/det_lu.cu compiles: the
    rows kernel exactly at the sizes of its SEMI_ROWS_CASE list, the warp
    kernel (any r) elsewhere."""
    compiled = _compiled("det_lu.cu", "SEMI_ROWS_CASE")
    assert sorted(compiled) == [(r,) for r in range(1, det.ROWS_MAX_R + 1)]
    for r in range(1, det.MAX_R + 1):
        assert det.det_variant(r) == ("rows" if (r,) in compiled else "warp")
        # a warp of the rows kernel owns at least two matrices
        assert det.det_variant(r) == "warp" or 32 // r >= 2


@pytest.mark.parametrize("r", [0, 65, -1])
def test_det_variant_rejects(r):
    with pytest.raises(ValueError, match="K1 takes"):
        det.det_variant(r)
