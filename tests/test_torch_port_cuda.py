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
matrices I + 0.3 noise/sqrt(r). K5 (`ops.wm_diag.wm_diag_derived`,
csrc/wm_diag.cu) likewise, 1e-12 in float64 and 1e-5 in float32 of each
output's largest entry, on identity-plus-noise monodromy planes.
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


def _wm_diag_inputs(n, d, dtype, device, seed):
    """K5's ten planes (identity-plus-noise monodromy, O(1) vectors) and the
    constant pack of diagonal widths omega in [0.001, 0.014], cell 1e4."""
    from semiclassical_tpu_torch.ops import wm_diag
    from semiclassical_tpu_torch.propagation import wm

    rng = np.random.default_rng(seed)
    eye = np.array([1.0, 0.0, 0.0, 1.0])[:, None, None]
    planes = list(eye + 0.3 * rng.standard_normal((4, n, d)))
    planes += list(rng.standard_normal((6, n, d)))
    G = np.diag(rng.uniform(0.001, 0.014, size=d))
    consts = wm.WMDiagConsts(**{
        k: torch.tensor(np.asarray(v, dtype=np.float64))
        for k, v in wm._diag_consts(G, G, G, 1e4, 1e4).items()})
    pack = wm_diag.build_const_pack(
        consts, torch.from_numpy(rng.standard_normal(d)), 2.5e-3)
    to = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return [to(p) for p in planes], to(pack)


@pytest.mark.parametrize("dtype, n, d, rtol", [
    (torch.float64, 1000, 60, 1e-12), (torch.float64, 257, 5, 1e-12),
    (torch.float64, 33, 1, 1e-12), (torch.float64, 100, 256, 1e-12),
    (torch.float64, 77, 33, 1e-12), (torch.float32, 300, 12, 1e-5),
    (torch.float32, 1000, 60, 1e-5)])
def test_wm_diag_kernel_matches_plain(card, dtype, n, d, rtol):
    """K5 against its plain version: every scal column and det plane within
    rtol of its own largest entry."""
    from semiclassical_tpu_torch.ops import wm_diag

    planes, pack = _wm_diag_inputs(n, d, dtype, card, seed=d)
    before = wm_diag.LAUNCHES
    scal, det_planes = wm_diag.wm_diag_derived(*planes, pack)
    torch.cuda.synchronize()
    assert wm_diag.LAUNCHES == before + 1
    assert scal.shape == (n, wm_diag.N_SCAL) and det_planes.shape == (4, n, d)
    scal_p, det_p = wm_diag.wm_diag_derived_plain(*planes, pack)
    err = ((scal - scal_p).abs().amax(0) / scal_p.abs().amax(0)).max()
    assert float(err) <= rtol
    err = ((det_planes - det_p).abs().amax((1, 2))
           / det_p.abs().amax((1, 2))).max()
    assert float(err) <= rtol


@pytest.mark.parametrize("case", ["d257", "float-pack", "non-contiguous"])
def test_wm_diag_wrapper_raises_on_card(card, case):
    from semiclassical_tpu_torch.ops import wm_diag

    planes, pack = _wm_diag_inputs(8, 257 if case == "d257" else 6,
                                   torch.float64, card, seed=1)
    if case == "float-pack":
        pack = pack.float()
    if case == "non-contiguous":
        planes[4] = planes[4].T.contiguous().T
    before = wm_diag.LAUNCHES
    with pytest.raises(ValueError):
        wm_diag.wm_diag_derived(*planes, pack)
    assert wm_diag.LAUNCHES == before
