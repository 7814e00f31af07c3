# coding: utf-8
"""The port's Gauss-Jordan kernels K2 (det + solve) and K3 (det + inverse)
(semiclassical_tpu_torch.ops.gj) and the WM eliminations of its `linalg`
against LAPACK and the JAX package.

On the CPU the port runs the kernels' plain PyTorch versions (the same
unpivoted eliminations in the same pivot order). They are held against

* numpy's LAPACK det / solve / inv at complex128, rtol 1e-10 on
  well-conditioned matrices (the two differ only in rounding order), and
* the Pallas kernels themselves (`pallas_batched_det_solve_lanes`,
  `pallas_batched_det_inv_lanes`, which always compute in complex64) in
  interpret mode, at complex64 and 1e-4 relative, the tolerance of
  tests/test_ops.py.

K2's size rule (`gj.solve_variant`: which layout of csrc/gj_det.cu a
shape takes) is a plain function and is checked here at the paths' shapes
and at its limits, and for every shape the kernel takes against the list of
layouts that file compiles. K3's (`gj.inv_variant`) likewise, against the
layouts parsed from the file.

The CUDA kernels themselves are compared with the plain versions on the
card by tests/test_torch_port_cuda.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import linalg as jax_linalg
from semiclassical_tpu.ops import (pallas_batched_det_inv_lanes,
                                   pallas_batched_det_solve_lanes)
from semiclassical_tpu_torch import linalg
from semiclassical_tpu_torch.ops import gj


def _well_conditioned(rng, n, m):
    return (np.eye(m)[None] + 0.3 * (rng.standard_normal((n, m, m))
                                     + 1j * rng.standard_normal((n, m, m)))
            / np.sqrt(m))


def _rhs(rng, n, m, k):
    return rng.standard_normal((n, m, k)) + 1j * rng.standard_normal((n, m, k))


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("k", [5, 6, 12])
@pytest.mark.parametrize("m", [2, 6, 12, 45])
def test_solve_plain_c128_matches_lapack(m, k):
    rng = np.random.default_rng(10 * m + k)
    A, B = _well_conditioned(rng, 20, m), _rhs(rng, 20, m, k)
    det, sol = gj.batched_det_solve_gj_plain(torch.from_numpy(A),
                                             torch.from_numpy(B))
    np.testing.assert_allclose(det.numpy(), np.linalg.det(A), rtol=1e-10,
                               atol=0)
    assert _rel(sol.numpy(), np.linalg.solve(A, B)) < 1e-10


@pytest.mark.parametrize("m", [2, 6, 12, 45])
def test_inv_plain_c128_matches_lapack(m):
    A = _well_conditioned(np.random.default_rng(m), 20, m)
    det, inv = gj.batched_det_inv_gj_plain(torch.from_numpy(A))
    np.testing.assert_allclose(det.numpy(), np.linalg.det(A), rtol=1e-10,
                               atol=0)
    assert _rel(inv.numpy(), np.linalg.inv(A)) < 1e-10


# both sides of the rows kernel's limit (16 | 17) and of 8 | 9, and the
# largest m of each block layout
@pytest.mark.parametrize("m", [8, 9, 16, 17, 32, 33, 48, 49, 64])
def test_inv_plain_c128_matches_lapack_at_the_rules_edges(m):
    A = _well_conditioned(np.random.default_rng(300 + m), 11, m)
    det, inv = gj.batched_det_inv_gj_plain(torch.from_numpy(A))
    np.testing.assert_allclose(det.numpy(), np.linalg.det(A), rtol=1e-10,
                               atol=0)
    assert _rel(inv.numpy(), np.linalg.inv(A)) < 1e-10


# n = 20 is deliberately not a multiple of the Pallas tile (16)
@pytest.mark.parametrize("m, k", [(6, 12), (6, 6), (6, 5)])
def test_solve_plain_c64_matches_pallas_interpret(m, k):
    rng = np.random.default_rng(100 + m + k)
    A = _well_conditioned(rng, 20, m).astype(np.complex64)
    B = _rhs(rng, 20, m, k).astype(np.complex64)
    det_ref, sol_ref = pallas_batched_det_solve_lanes(
        jnp.asarray(A), jnp.asarray(B), tile=16)
    det, sol = gj.batched_det_solve_gj_plain(torch.from_numpy(A),
                                             torch.from_numpy(B))
    assert det.dtype == sol.dtype == torch.complex64
    assert _rel(det.numpy(), np.asarray(det_ref)) < 1e-4
    assert _rel(sol.numpy(), np.asarray(sol_ref)) < 1e-4


@pytest.mark.parametrize("m", [6, 12])
def test_inv_plain_c64_matches_pallas_interpret(m):
    A = _well_conditioned(np.random.default_rng(200 + m), 20, m).astype(
        np.complex64)
    det_ref, inv_ref = pallas_batched_det_inv_lanes(jnp.asarray(A), tile=16)
    det, inv = gj.batched_det_inv_gj_plain(torch.from_numpy(A))
    assert det.dtype == inv.dtype == torch.complex64
    assert _rel(det.numpy(), np.asarray(det_ref)) < 1e-4
    assert _rel(inv.numpy(), np.asarray(inv_ref)) < 1e-4


@pytest.fixture()
def jax_xla():
    """JAX's linalg on its LAPACK ("xla") implementation, restored after."""
    old = jax_linalg._LINALG_IMPL
    jax_linalg.set_linalg_impl("xla")
    yield jax_linalg
    jax_linalg.set_linalg_impl(old)


def _blocks(M, r):
    return M[:, :r, :r], M[:, :r, r:], M[:, r:, :r], M[:, r:, r:]


def test_linalg_coumarin_leaves_match_jax(jax_xla, caplog):
    """The WM A-solve at coumarin's rank: 2r = 90 split into two m = 45
    leaves, k = 45, so K2 sees (45 | 90) and then (45 | 45)."""
    rng = np.random.default_rng(45)
    A, B = _well_conditioned(rng, 5, 90), _rhs(rng, 5, 90, 45)
    det_ref, Y_ref = jax_xla.batched_det_solve_blocks(
        *_blocks(jnp.asarray(A), 45), jnp.asarray(B[:, :45]),
        jnp.asarray(B[:, 45:]))
    linalg._K2_LEAVES.clear()
    with caplog.at_level("INFO", logger=linalg.logger.name):
        det, Y = linalg.batched_det_solve_blocks(
            *_blocks(torch.from_numpy(A), 45), torch.from_numpy(B[:, :45]),
            torch.from_numpy(B[:, 45:]))
    assert linalg._K2_LEAVES == {(45, 90), (45, 45)}
    assert "(45 | 90)" in caplog.text and "(45 | 45)" in caplog.text
    np.testing.assert_allclose(det.numpy(), np.asarray(det_ref), rtol=1e-10,
                               atol=0)
    assert _rel(Y.numpy(), np.asarray(Y_ref)) < 1e-10


def test_linalg_det_solve_blocks_matches_jax(jax_xla):
    """The WM A-solve shape: m = 12 split into two 6 x 6 leaves, k = 6."""
    rng = np.random.default_rng(12)
    A, B = _well_conditioned(rng, 20, 12), _rhs(rng, 20, 12, 6)
    det_ref, Y_ref = jax_xla.batched_det_solve_blocks(
        *_blocks(jnp.asarray(A), 6), jnp.asarray(B[:, :6]),
        jnp.asarray(B[:, 6:]))
    At = torch.from_numpy(A)
    det, Y = linalg.batched_det_solve_blocks(
        *_blocks(At, 6), torch.from_numpy(B[:, :6]),
        torch.from_numpy(B[:, 6:]))
    np.testing.assert_allclose(det.numpy(), np.asarray(det_ref), rtol=1e-10,
                               atol=0)
    assert _rel(Y.numpy(), np.asarray(Y_ref)) < 1e-10


@pytest.mark.parametrize("shape", [(20,), (4, 5)], ids=["n", "batch-2d"])
def test_linalg_det_inv_and_solve_match_jax(jax_xla, shape):
    rng = np.random.default_rng(len(shape))
    A = _well_conditioned(rng, 20, 12).reshape(shape + (12, 12))
    B = _rhs(rng, 20, 12, 5).reshape(shape + (12, 5))
    det_ref, inv_ref = jax_xla.batched_det_inv(jnp.asarray(A))
    det, inv = linalg.batched_det_inv(torch.from_numpy(A))
    assert det.shape == shape and inv.shape == A.shape
    np.testing.assert_allclose(det.numpy(), np.asarray(det_ref), rtol=1e-10,
                               atol=0)
    assert _rel(inv.numpy(), np.asarray(inv_ref)) < 1e-10
    det_ref, Y_ref = jax_xla.batched_det_solve(jnp.asarray(A), jnp.asarray(B))
    det, Y = linalg.batched_det_solve(torch.from_numpy(A),
                                      torch.from_numpy(B))
    assert Y.shape == B.shape
    np.testing.assert_allclose(det.numpy(), np.asarray(det_ref), rtol=1e-10,
                               atol=0)
    assert _rel(Y.numpy(), np.asarray(Y_ref)) < 1e-10


def test_linalg_above_the_leaf_matches_lapack():
    """m = 80 > 64: one block-Schur level splits it into 40 x 40 leaves."""
    rng = np.random.default_rng(80)
    A, B = _well_conditioned(rng, 6, 80), _rhs(rng, 6, 80, 7)
    det, inv = linalg.batched_det_inv(torch.from_numpy(A))
    np.testing.assert_allclose(det.numpy(), np.linalg.det(A), rtol=1e-10,
                               atol=0)
    assert _rel(inv.numpy(), np.linalg.inv(A)) < 1e-10
    det, Y = linalg.batched_det_solve(torch.from_numpy(A),
                                      torch.from_numpy(B))
    np.testing.assert_allclose(det.numpy(), np.linalg.det(A), rtol=1e-10,
                               atol=0)
    assert _rel(Y.numpy(), np.linalg.solve(A, B)) < 1e-10
    det, Y = linalg.batched_det_solve_blocks(
        *_blocks(torch.from_numpy(A), 40), torch.from_numpy(B[:, :40]),
        torch.from_numpy(B[:, 40:]))
    assert _rel(Y.numpy(), np.linalg.solve(A, B)) < 1e-10


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(3)
    A = torch.from_numpy(_well_conditioned(rng, 9, 6))
    B = torch.from_numpy(_rhs(rng, 9, 6, 5))
    before = dict(gj.LAUNCHES)
    det, sol = gj.batched_det_solve_gj(A, B)
    det_p, sol_p = gj.batched_det_solve_gj_plain(A, B)
    assert torch.equal(det, det_p) and torch.equal(sol, sol_p)
    det, inv = gj.batched_det_inv_gj(A)
    det_p, inv_p = gj.batched_det_inv_gj_plain(A)
    assert torch.equal(det, det_p) and torch.equal(inv, inv_p)
    linalg.batched_det_solve_blocks(*_blocks(A, 3), B[:, :3], B[:, 3:])
    assert gj.LAUNCHES == before


def test_other_devices_raise():
    A = torch.empty((4, 6, 6), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gj.batched_det_inv_gj(A)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gj.batched_det_solve_gj(A, torch.zeros((4, 6, 2),
                                               dtype=torch.complex128))


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("m, k", [(1, 1), (6, 12), (64, 128), (60, 120)])
def test_arg_checks_accept(dtype, m, k):
    gj.check_solve_args(torch.zeros((3, m, m), dtype=dtype),
                        torch.zeros((3, m, k), dtype=dtype))
    gj.check_inv_args(torch.zeros((3, m, m), dtype=dtype))


_c128 = lambda *s: torch.zeros(s, dtype=torch.complex128)


@pytest.mark.parametrize("A, B, match", [
    (_c128(3, 65, 65), _c128(3, 65, 5), "m <= 64"),
    (_c128(3, 64, 64), _c128(3, 64, 129), "m \\+ k <= 192"),
    (torch.zeros((3, 6, 6)), torch.zeros((3, 6, 5)), "complex128 or complex64"),
    (_c128(3, 6, 7)[:, :, :6], _c128(3, 6, 5), "contiguous"),
    (_c128(3, 6, 6), _c128(3, 6, 9)[:, :, :5], "contiguous"),
    (_c128(3, 6, 5), _c128(3, 6, 5), "batch"),
    (_c128(3, 6, 6), _c128(3, 5, 5), "B of shape"),
    (_c128(3, 6, 6), torch.zeros((3, 6, 5), dtype=torch.complex64), "one type"),
], ids=["m65", "width193", "float64", "A-non-contiguous", "B-non-contiguous",
        "non-square", "B-rows", "mixed-types"])
def test_solve_arg_check_rejects(A, B, match):
    with pytest.raises(ValueError, match=match):
        gj.check_solve_args(A, B)


@pytest.mark.parametrize("A, match", [
    (_c128(3, 65, 65), "m <= 64"),
    (torch.zeros((3, 6, 6)), "complex128 or complex64"),
    (_c128(3, 6, 7)[:, :, :6], "contiguous"),
    (_c128(3, 6, 5), "batch"),
    (_c128(6, 6), "batch"),
], ids=["m65", "float64", "non-contiguous", "non-square", "2d"])
def test_inv_arg_check_rejects(A, match):
    with pytest.raises(ValueError, match=match):
        gj.check_inv_args(A)


# (m, k) -> (kind, warps, tile rows, tile columns, chunks): methylium's
# leaves, coumarin's three, the flagship's, both sides of the warp kernel's
# limits (m = 8, m + k = 64), each row layout's largest m, B in three chunks
@pytest.mark.parametrize("m, k, variant", [
    (6, 12, ("warp", 1, 0, 0, 1)), (6, 6, ("warp", 1, 0, 0, 1)),
    (6, 5, ("warp", 1, 0, 0, 1)), (1, 1, ("warp", 1, 0, 0, 1)),
    (8, 56, ("warp", 1, 0, 0, 1)), (8, 57, ("block", 8, 2, 3, 1)),
    (9, 5, ("block", 8, 2, 1, 1)), (45, 90, ("block", 8, 6, 3, 2)),
    (45, 45, ("block", 8, 6, 3, 1)), (45, 5, ("block", 8, 6, 2, 1)),
    (60, 120, ("block", 16, 4, 4, 2)), (64, 128, ("block", 16, 4, 4, 2)),
    (16, 176, ("block", 8, 2, 6, 1)), (17, 1, ("block", 8, 4, 1, 1)),
    (32, 160, ("block", 8, 4, 4, 2)), (33, 159, ("block", 8, 6, 3, 3)),
    (48, 48, ("block", 8, 6, 3, 1)), (49, 1, ("block", 16, 4, 2, 1)),
])
def test_solve_variant(m, k, variant):
    assert gj.solve_variant(m, k) == gj.SolveVariant(*variant)
    assert (gj.WARP_MAX_M, gj.WARP_MAX_WIDTH) == (8, 64)


def test_solve_variant_covers_every_shape():
    """Every shape K2 takes gets a layout that csrc/gj_det.cu compiles
    (its SEMI_BLOCK_CASE list) and that its launcher accepts: the tile
    covers the matrix and its widest chunk, no chunk is empty, and the
    tile is no wider than the chunk needs."""
    compiled = ({(8, 2, c) for c in range(1, 7)}
                | {(8, 4, c) for c in range(1, 5)} | {(8, 6, 2), (8, 6, 3)}
                | {(16, 4, 2), (16, 4, 3), (16, 4, 4)})
    for m in range(1, gj.MAX_M + 1):
        for k in range(1, gj.MAX_WIDTH - m + 1):
            v = gj.solve_variant(m, k)
            if m <= 8 and m + k <= 64:
                assert v.kind == "warp" and v.warps == 1
                assert m * (m + k) * 16 <= 48 * 1024
                continue
            assert v.kind == "block"
            assert (v.warps, v.tile_rows, v.tile_cols) in compiled, (m, k, v)
            widest = m + -(-k // v.chunks)
            assert v.warps * v.tile_rows >= m, (m, k, v)
            assert 32 * (v.tile_cols - 1) < widest <= 32 * v.tile_cols
            assert (v.chunks - 1) * (widest - m) < k, (m, k, v)


@pytest.mark.parametrize("m, k", [(0, 1), (65, 1), (6, 0), (64, 129),
                                  (1, 192)])
def test_solve_variant_rejects(m, k):
    with pytest.raises(ValueError, match="K2 takes"):
        gj.solve_variant(m, k)


def _compiled(macro):
    """The argument lists of the uses of `macro` in csrc/gj_det.cu (its
    definition, which names its parameters, is not one)."""
    text = (pathlib.Path(gj.__file__).resolve().parents[1] / "csrc"
            / "gj_det.cu").read_text()
    return [tuple(int(x) for x in args.split(","))
            for args in re.findall(macro + r"\(([0-9, ]+)\)", text)]


def test_compiled_solve_layouts_are_the_listed_ones():
    """The list `test_solve_variant_covers_every_shape` walks is the
    SEMI_BLOCK_CASE list of the source."""
    assert set(_compiled("SEMI_BLOCK_CASE")) == (
        {(8, 2, c) for c in range(1, 7)} | {(8, 4, c) for c in range(1, 5)}
        | {(8, 6, 2), (8, 6, 3)} | {(16, 4, 2), (16, 4, 3), (16, 4, 4)})


# methylium's trackers, coumarin's leaf, the flagship's, both sides of the
# rows kernel's limit, each block layout's largest m
@pytest.mark.parametrize("m, variant", [
    (6, ("rows", 0, 0, 0)), (12, ("rows", 0, 0, 0)), (1, ("rows", 0, 0, 0)),
    (8, ("rows", 0, 0, 0)), (9, ("rows", 0, 0, 0)), (16, ("rows", 0, 0, 0)),
    (17, ("block", 4, 5, 1)), (20, ("block", 4, 5, 1)),
    (21, ("block", 4, 6, 1)), (24, ("block", 4, 6, 1)),
    (25, ("block", 4, 7, 1)), (28, ("block", 4, 7, 1)),
    (29, ("block", 4, 8, 1)), (32, ("block", 4, 8, 1)),
    (33, ("block", 8, 6, 2)), (45, ("block", 8, 6, 2)),
    (48, ("block", 8, 6, 2)), (49, ("block", 16, 4, 2)),
    (60, ("block", 16, 4, 2)), (64, ("block", 16, 4, 2)),
])
def test_inv_variant(m, variant):
    assert gj.inv_variant(m) == gj.InvVariant(*variant)
    assert gj.ROWS_MAX_M == 16


def test_inv_variant_covers_every_size():
    """Every m K3 takes gets a layout that csrc/gj_det.cu compiles (its
    SEMI_INV_ROWS_CASE and SEMI_INV_BLOCK_CASE lists) and that its launcher
    accepts: the rows kernel at its compiled sizes, a block tile that
    covers the matrix and is no larger than it needs."""
    rows = _compiled("SEMI_INV_ROWS_CASE")
    blocks = _compiled("SEMI_INV_BLOCK_CASE")
    assert sorted(rows) == [(m,) for m in range(1, gj.ROWS_MAX_M + 1)]
    used = set()
    for m in range(1, gj.MAX_M + 1):
        v = gj.inv_variant(m)
        if (m,) in rows:
            assert v == gj.InvVariant("rows", 0, 0, 0), m
            continue
        assert v.kind == "block"
        assert (v.warps, v.tile_rows, v.tile_cols) in blocks, (m, v)
        assert v.warps * v.tile_rows >= m, (m, v)
        assert 32 * (v.tile_cols - 1) < m <= 32 * v.tile_cols, (m, v)
        used.add((v.warps, v.tile_rows, v.tile_cols))
    # nothing is compiled that no size takes
    assert used == set(blocks)


@pytest.mark.parametrize("m", [0, 65, -3])
def test_inv_variant_rejects(m):
    with pytest.raises(ValueError, match="K3 takes"):
        gj.inv_variant(m)
