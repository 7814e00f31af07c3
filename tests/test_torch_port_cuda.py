# coding: utf-8
"""Tests of the port's CUDA kernels that need an NVIDIA GPU (marker
`cuda`; each skips where there is no card).

This file imports neither jax nor semiclassical_tpu, so that it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

K1 (`ops.det.batched_det`, csrc/det_lu.cu), K2 and K3
(`ops.gj.batched_det_solve_gj` / `batched_det_inv_gj`, csrc/gj_det.cu; each
at both sides of its size rule, K2 and K3 with every tile layout of their
block kernel, K1 and K3 with batches that fill no whole warp of their
many-matrices-per-warp kernels)
are held against their plain PyTorch versions on the same inputs: 1e-12
relative in complex128 and 1e-5 in complex64 (rounding-order differences
of the same elimination, FMA contraction included), on well-conditioned
matrices I + 0.3 noise/sqrt(r). K5 (`ops.wm_diag.wm_diag_derived`,
csrc/wm_diag.cu) likewise, 1e-12 in float64 and 1e-5 in float32 of each
output's largest entry, on identity-plus-noise monodromy planes, in both
variants of its layout rule (vector loads; scalar loads for planes that do
not start on a 16-byte boundary, as views of one (4, n, d) tensor at odd
n d), at d around every lane and vector edge, at ragged n and n = 0. K4
(`ops.det_block.batched_det_block`, csrc/det_lu_block.cu, one thread block
per matrix) is held against the same plain version as K1 at the same
limits, and `linalg.batched_det` is checked to launch K1 for r <=
`linalg.DET_WARP_MAX_R` and K4 above. K3 also runs at the WM norm's pair
blocks (bi, bj, r, r) through `linalg.batched_det_inv`, with bi bj
matrices that fill no whole warp; and the HK and WM norms on the card
equal the same norms on the CPU to 1e-10 relative, with one K3 launch per
block pair of the WM norm. K6 (`ops.diag_mono.diag_mono_step`,
csrc/diag_mono.cu, the diagonal monodromy's RK4 step) is held against its
plain version at 1e-14 in float64 and 1e-5 in float32 of the planes'
largest entry (it rounds each operation as the plain version does, so the
two should agree bit for bit), in both variants of its layout rule, on a
sub-batch's plane-strided view, with aliased and broadcast stage
diagonals; its wrapper raises on what it does not take. K8
(`ops.observe.observe` / `prefactor`, csrc/observe.cu, the separable
step's observe) is held against the PyTorch chain it replaces
(`hk.hk_observe`; for WM's prefactor `hk_prefactor_det`, `SignTracker`)
on the same rows of a 60-mode Morse batch moved 20 steps: C^2 and c
within 1e-14 of their largest modulus, the signs equal, the sums within
1e-14 (the moments 2e-14), in both variants of its layout rule, on
sub-batch views, on planes one number off 16 bytes, at odd d and at
batches that fill no whole block; two launches agree bit for bit, and the
time loop's graphs equal its eager runs bit for bit.
"""

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch import linalg, ops
from semiclassical_tpu_torch.ops import det, gj

pytestmark = pytest.mark.cuda


def _launches(label):
    """The launches of kernel `label` so far, in either type."""
    return sum(ops.launch_counts()[label].values())


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
    (torch.complex128, 64, 100, 1e-12), (torch.complex64, 64, 100, 1e-5),
    # the rows kernel to r = 16 (both sides of 8 | 9 and of 16 | 17, a batch
    # that fills no whole warp of 32 // r matrices), the warp kernel above
    (torch.complex128, 8, 10001, 1e-12), (torch.complex64, 8, 10001, 1e-5),
    (torch.complex128, 9, 10001, 1e-12), (torch.complex64, 9, 10001, 1e-5),
    (torch.complex128, 16, 1001, 1e-12), (torch.complex64, 16, 1001, 1e-5),
    (torch.complex128, 17, 1001, 1e-12), (torch.complex64, 17, 1001, 1e-5),
    (torch.complex128, 5, 3, 1e-12), (torch.complex128, 12, 1, 1e-12),
    (torch.complex128, linalg.DET_WARP_MAX_R, 1001, 1e-12),
    (torch.complex128, linalg.DET_WARP_MAX_R + 1, 1001, 1e-12)])
def test_kernel_matches_plain(card, dtype, r, n, rtol):
    A = _well_conditioned(n, r, dtype, card, seed=r)
    before = _launches("K1")
    got = det.batched_det(A)
    torch.cuda.synchronize()
    assert _launches("K1") == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    ref = det.batched_det_lu_plain(A)
    assert float(((got - ref).abs() / ref.abs()).max()) <= rtol


def test_empty_batch_launches_nothing(card):
    before = _launches("K1")
    got = det.batched_det(torch.empty((0, 6, 6), dtype=torch.complex128,
                                      device=card))
    assert got.shape == (0,) and _launches("K1") == before


@pytest.mark.parametrize("make", [
    lambda d: torch.zeros((4, 65, 65), dtype=torch.complex128, device=d),
    lambda d: torch.zeros((4, 6, 7), dtype=torch.complex128, device=d)[:, :, :6],
    lambda d: torch.zeros((4, 6, 6), dtype=torch.float64, device=d),
], ids=["r65", "non-contiguous", "float64"])
def test_wrapper_raises_on_card(card, make):
    before = _launches("K1")
    with pytest.raises(ValueError):
        det.batched_det(make(card))
    assert _launches("K1") == before


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# K2's two layouts (`gj.solve_variant`): the warp kernel to (8 | 56), with a
# batch that is not a multiple of its 4 matrices per block, the block kernel
# above, with every row layout (m <= 16, 32, 48, 64), B in one, two and
# three chunks, and the widest tiles
@pytest.mark.parametrize("dtype, m, k, n, rtol", [
    (torch.complex128, 6, 12, 1000, 1e-12), (torch.complex64, 6, 12, 1000, 1e-5),
    (torch.complex128, 6, 5, 1000, 1e-12), (torch.complex128, 1, 1, 33, 1e-12),
    (torch.complex128, 60, 120, 64, 1e-12), (torch.complex128, 64, 128, 40, 1e-12),
    (torch.complex64, 45, 45, 100, 1e-5),
    (torch.complex128, 6, 12, 1001, 1e-12), (torch.complex128, 8, 56, 101, 1e-12),
    (torch.complex128, 8, 57, 101, 1e-12), (torch.complex128, 9, 5, 101, 1e-12),
    (torch.complex128, 16, 176, 50, 1e-12), (torch.complex128, 17, 100, 50, 1e-12),
    (torch.complex128, 32, 160, 50, 1e-12), (torch.complex128, 33, 159, 50, 1e-12),
    (torch.complex128, 45, 90, 257, 1e-12), (torch.complex128, 45, 5, 257, 1e-12),
    (torch.complex128, 49, 1, 50, 1e-12), (torch.complex128, 64, 1, 50, 1e-12),
    (torch.complex64, 45, 90, 257, 1e-5), (torch.complex64, 64, 128, 40, 1e-5)])
def test_solve_kernel_matches_plain(card, dtype, m, k, n, rtol):
    A = _well_conditioned(n, m, dtype, card, seed=m)
    B = _well_conditioned(n, max(m, k), dtype, card, seed=k)[:, :m, :k]
    B = B.contiguous()
    assert gj.solve_variant(m, k).kind == (
        "warp" if m <= 8 and m + k <= 64 else "block")
    before = _launches("K2")
    det, sol = gj.batched_det_solve_gj(A, B)
    torch.cuda.synchronize()
    assert _launches("K2") == before + 1
    assert det.shape == (n,) and sol.shape == (n, m, k)
    det_p, sol_p = gj.batched_det_solve_gj_plain(A, B)
    assert float(((det - det_p).abs() / det_p.abs()).max()) <= rtol
    assert _rel(sol, sol_p) <= rtol


@pytest.mark.parametrize("dtype, m, n, rtol", [
    (torch.complex128, 12, 1000, 1e-12), (torch.complex64, 12, 1000, 1e-5),
    (torch.complex128, 6, 1000, 1e-12), (torch.complex128, 1, 33, 1e-12),
    (torch.complex128, 60, 64, 1e-12), (torch.complex128, 64, 40, 1e-12),
    # the rows kernel to m = 16 (a batch that fills no whole warp of
    # 32 // m matrices), every layout of the block kernel above
    (torch.complex128, 8, 10001, 1e-12), (torch.complex64, 8, 10001, 1e-5),
    (torch.complex128, 9, 10001, 1e-12), (torch.complex64, 9, 10001, 1e-5),
    (torch.complex128, 16, 1001, 1e-12), (torch.complex64, 16, 1001, 1e-5),
    (torch.complex128, 17, 1001, 1e-12), (torch.complex64, 17, 1001, 1e-5),
    (torch.complex128, 5, 3, 1e-12), (torch.complex128, 12, 1, 1e-12),
    (torch.complex128, 20, 101, 1e-12), (torch.complex128, 21, 101, 1e-12),
    (torch.complex128, 24, 101, 1e-12), (torch.complex64, 25, 101, 1e-5),
    (torch.complex128, 28, 101, 1e-12), (torch.complex128, 29, 101, 1e-12),
    (torch.complex128, 32, 101, 1e-12), (torch.complex128, 33, 101, 1e-12),
    (torch.complex128, 45, 257, 1e-12), (torch.complex64, 45, 257, 1e-5),
    (torch.complex128, 48, 101, 1e-12), (torch.complex128, 49, 101, 1e-12),
    (torch.complex64, 60, 64, 1e-5), (torch.complex64, 64, 40, 1e-5)])
def test_inv_kernel_matches_plain(card, dtype, m, n, rtol):
    A = _well_conditioned(n, m, dtype, card, seed=m)
    assert gj.inv_variant(m).kind == ("rows" if m <= 16 else "block")
    before = _launches("K3")
    det, inv = gj.batched_det_inv_gj(A)
    torch.cuda.synchronize()
    assert _launches("K3") == before + 1
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
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        gj.batched_det_solve_gj(A, B)
    if A.shape[1] > gj.MAX_M:
        with pytest.raises(ValueError):
            gj.batched_det_inv_gj(A)
    assert ops.launch_counts() == before


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
    before = _launches("K5")
    scal, det_planes = wm_diag.wm_diag_derived(*planes, pack)
    torch.cuda.synchronize()
    assert _launches("K5") == before + 1
    assert scal.shape == (n, wm_diag.N_SCAL) and det_planes.shape == (4, n, d)
    scal_p, det_p = wm_diag.wm_diag_derived_plain(*planes, pack)
    err = ((scal - scal_p).abs().amax(0) / scal_p.abs().amax(0)).max()
    assert float(err) <= rtol
    err = ((det_planes - det_p).abs().amax((1, 2))
           / det_p.abs().amax((1, 2))).max()
    assert float(err) <= rtol


def _wm_diag_check(planes, pack, rtol):
    """One K5 launch on `planes` against the plain version: every scal
    column and det plane within rtol of its own largest entry."""
    from semiclassical_tpu_torch.ops import wm_diag

    n, d = planes[0].shape
    before = _launches("K5")
    scal, det_planes = wm_diag.wm_diag_derived(*planes, pack)
    torch.cuda.synchronize()
    assert _launches("K5") == before + 1
    assert scal.shape == (n, wm_diag.N_SCAL) and det_planes.shape == (4, n, d)
    assert bool(torch.isfinite(scal).all() and torch.isfinite(det_planes).all())
    scal_p, det_p = wm_diag.wm_diag_derived_plain(*planes, pack)
    scale = scal_p.abs().amax(0)
    err = ((scal - scal_p).abs().amax(0)
           / torch.where(scale > 0, scale, 1.0)).max()
    assert float(err) <= rtol
    err = ((det_planes - det_p).abs().amax((1, 2))
           / det_p.abs().amax((1, 2))).max()
    assert float(err) <= rtol


_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("d", [7, 8, 9, 31, 32, 33, 64, 65, 255, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wm_diag_kernel_at_chunk_edges(card, dtype, d):
    """K5 at d on both sides of a vector, of a pass of 4, 8 and 16 lanes
    and at the largest d, with a batch that fills no whole block."""
    planes, pack = _wm_diag_inputs(101, d, dtype, card, seed=d)
    _wm_diag_check(planes, pack, _RTOL[dtype])


@pytest.mark.parametrize("n", [5, 15, 17, 4099])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wm_diag_kernel_ragged_batches(card, dtype, n):
    """K5 at the flagship's d = 60 with n smaller than one block's rows and
    n that is no multiple of them (the vector variant)."""
    from semiclassical_tpu_torch.ops import wm_diag

    planes, pack = _wm_diag_inputs(n, 60, dtype, card, seed=n)
    assert wm_diag.layout_of(planes).variant == "vector"
    _wm_diag_check(planes, pack, _RTOL[dtype])


@pytest.mark.parametrize("dtype, n, d", [
    (torch.float64, 1001, 5), (torch.float64, 33, 63),
    (torch.float32, 1001, 5), (torch.float32, 33, 63),
    (torch.float32, 1001, 6)])
def test_wm_diag_kernel_on_views(card, dtype, n, d):
    """K5 on Mqq .. Mpp passed as the four views of one (4, n, d) tensor,
    as `propagation.wm.wm_diag_inputs` passes them: at odd n d (and at
    float32 n d = 2 mod 4) the views after the first are not 16-byte
    aligned and run the scalar variant."""
    from semiclassical_tpu_torch.ops import wm_diag

    planes, pack = _wm_diag_inputs(n, d, dtype, card, seed=n + d)
    Z = torch.stack(planes[:4]).contiguous()
    views = [*Z, *planes[4:]]
    assert Z[1].data_ptr() % 16 != 0
    assert wm_diag.layout_of(views).variant == "scalar"
    _wm_diag_check(views, pack, _RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wm_diag_kernel_on_narrowed_planes(card, dtype):
    """At d = 60, planes narrowed one element into a flat tensor run the
    scalar variant, the same planes aligned the vector variant; both match
    the plain version."""
    from semiclassical_tpu_torch.ops import wm_diag

    n, d = 1001, 60
    planes, pack = _wm_diag_inputs(n, d, dtype, card, seed=11)
    narrowed = [torch.cat([x.new_zeros(1), x.reshape(-1)]).narrow(0, 1, n * d)
                .view(n, d) for x in planes]
    assert wm_diag.layout_of(planes).variant == "vector"
    assert wm_diag.layout_of(narrowed).variant == "scalar"
    _wm_diag_check(planes, pack, _RTOL[dtype])
    _wm_diag_check(narrowed, pack, _RTOL[dtype])


def test_wm_diag_empty_batch_launches_nothing(card):
    from semiclassical_tpu_torch.ops import wm_diag

    planes, pack = _wm_diag_inputs(0, 60, torch.float64, card, seed=0)
    before = _launches("K5")
    scal, det_planes = wm_diag.wm_diag_derived(*planes, pack)
    assert _launches("K5") == before
    assert scal.shape == (0, wm_diag.N_SCAL) and det_planes.shape == (4, 0, 60)


@pytest.mark.parametrize("case", ["d257", "float-pack", "non-contiguous"])
def test_wm_diag_wrapper_raises_on_card(card, case):
    from semiclassical_tpu_torch.ops import wm_diag

    planes, pack = _wm_diag_inputs(8, 257 if case == "d257" else 6,
                                   torch.float64, card, seed=1)
    if case == "float-pack":
        pack = pack.float()
    if case == "non-contiguous":
        planes[4] = planes[4].T.contiguous().T
    before = _launches("K5")
    with pytest.raises(ValueError):
        wm_diag.wm_diag_derived(*planes, pack)
    assert _launches("K5") == before


def _diag_mono_inputs(n, d, dtype, device, seed, rows=None):
    """K6's inputs: Z (4, rows, d) identity plus noise, 1/m of d modes and
    four Morse-like stage diagonals of both signs (rows = n by default)."""
    rng = np.random.default_rng(seed)
    rows = n if rows is None else rows
    Z = 0.3 * rng.standard_normal((4, rows, d))
    Z[0::3] += 1.0
    inv_m = 1.0 / rng.uniform(0.5, 2.0, d)
    hs = [rng.uniform(-0.2, 1.0, (rows, d)) * rng.uniform(1e-6, 1e-3, d)
          for _ in range(4)]
    to = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)
    return to(Z), to(inv_m), tuple(to(h) for h in hs)


_DIAG_MONO_RTOL = {torch.float64: 1e-14, torch.float32: 1e-5}


def _diag_mono_check(Z, inv_m, hs, variant):
    """One K6 launch in the `variant` of its layout rule against the plain
    version: the largest difference within 1e-14 (float64) / 1e-5
    (float32) of the planes' largest entry."""
    from semiclassical_tpu_torch.ops import diag_mono
    from semiclassical_tpu_torch.propagation import eom

    w = eom._rk4_weights(0.2, Z.dtype)
    assert diag_mono.layout_of(Z, hs).variant == variant
    before = _launches("K6")
    got = diag_mono.diag_mono_step(Z, inv_m, hs, w)
    torch.cuda.synchronize()
    assert _launches("K6") == before + 1
    assert got.shape == (4, *Z.shape[1:]) and got.is_contiguous()
    ref = diag_mono.diag_mono_step_plain(Z, inv_m, hs, w)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= _DIAG_MONO_RTOL[Z.dtype]


@pytest.mark.parametrize("n, d, variant", [
    (98304, 60, "vector"), (1, 60, "vector"), (1001, 61, "scalar"),
    (4097, 4, "vector"), (33, 1, "scalar"), (12, 1, "vector")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_diag_mono_kernel_matches_plain(card, dtype, n, d, variant):
    """K6 against its plain version at the AS model's shape, n = 1, odd n
    and d (the new planes off 16 bytes: the scalar variant) and small d."""
    if dtype == torch.float32 and n * d % 4:
        variant = "scalar"
    _diag_mono_check(*_diag_mono_inputs(n, d, dtype, card, seed=n + d),
                     variant)


@pytest.mark.parametrize("a, b, d, variant", [(8192, 16384, 60, "vector"),
                                              (1, 1002, 61, "scalar")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_diag_mono_kernel_on_plane_views(card, dtype, a, b, d, variant):
    """K6 on a sub-batch's view Z[:, a:b] of a (4, 98304, d) state, as
    `micro_batch` passes it: planes 98304 rows apart, with no copy (at an
    odd offset of an odd d, off 16 bytes: the scalar variant)."""
    Z, inv_m, hs = _diag_mono_inputs(b - a, d, dtype, card, seed=a,
                                     rows=98304)
    _diag_mono_check(Z[:, a:b], inv_m, tuple(h[a:b] for h in hs), variant)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_diag_mono_kernel_with_aliased_and_broadcast_h(card, dtype):
    """One stage tensor passed four times (the frozen "step" and "taylor"
    modes) and a stage diagonal that is one row expanded over the batch
    (the harmonic Morse model's Hessian)."""
    Z, inv_m, hs = _diag_mono_inputs(98304, 60, dtype, card, seed=5)
    _diag_mono_check(Z, inv_m, (hs[2],) * 4, "vector")
    row = hs[0][7:8].expand(98304, 60)
    _diag_mono_check(Z, inv_m, (row, hs[1], row, hs[3]), "vector")


def test_diag_mono_empty_batch_launches_nothing(card):
    from semiclassical_tpu_torch.ops import diag_mono

    Z, inv_m, hs = _diag_mono_inputs(0, 60, torch.float64, card, seed=0)
    before = _launches("K6")
    got = diag_mono.diag_mono_step(Z, inv_m, hs, (0.1, 0.2, 0.3, 0.6))
    assert _launches("K6") == before and got.shape == (4, 0, 60)


@pytest.mark.parametrize("case", ["mixed dtypes", "rows apart", "h shape",
                                  "cpu inv_m"])
def test_diag_mono_wrapper_raises_on_card(card, case):
    from semiclassical_tpu_torch.ops import diag_mono

    Z, inv_m, hs = _diag_mono_inputs(16, 6, torch.float64, card, seed=2)
    if case == "mixed dtypes":
        hs = (hs[0].float(), *hs[1:])
    elif case == "rows apart":
        Z = torch.zeros(4, 16, 8, dtype=Z.dtype, device=card)[:, :, :6]
    elif case == "h shape":
        hs = (hs[0][:15], *hs[1:])
    elif case == "cpu inv_m":
        inv_m = inv_m.cpu()
    before = _launches("K6")
    with pytest.raises(ValueError):
        diag_mono.diag_mono_step(Z, inv_m, hs, (0.1, 0.2, 0.3, 0.6))
    assert _launches("K6") == before


@pytest.mark.parametrize("dtype, r, n, rtol", [
    (torch.complex128, 45, 2048, 1e-12), (torch.complex64, 45, 2048, 1e-5),
    (torch.complex128, 64, 300, 1e-12), (torch.complex64, 64, 300, 1e-5),
    (torch.complex128, 33, 257, 1e-12), (torch.complex128, 1, 33, 1e-12),
    (torch.complex128, 6, 1000, 1e-12), (torch.complex128, 16, 100, 1e-12),
    (torch.complex128, 17, 100, 1e-12), (torch.complex128, 32, 100, 1e-12),
    (torch.complex128, 48, 100, 1e-12), (torch.complex128, 49, 100, 1e-12),
    (torch.complex64, 33, 257, 1e-5)])
def test_block_kernel_matches_plain(card, dtype, r, n, rtol):
    """K4 against the plain elimination it shares with K1, and against
    torch.linalg.det (a pivoted LU: 1e-10 in complex128, 1e-4 in
    complex64)."""
    from semiclassical_tpu_torch.ops import det_block

    A = _well_conditioned(n, r, dtype, card, seed=100 + r)
    before = _launches("K4")
    got = det_block.batched_det_block(A)
    torch.cuda.synchronize()
    assert _launches("K4") == before + 1
    assert got.dtype == dtype and got.shape == (n,)
    ref = det_block.batched_det_lu_plain(A)
    assert float(((got - ref).abs() / ref.abs()).max()) <= rtol
    oracle = torch.linalg.det(A.to(torch.complex128))
    lim = 1e-10 if dtype == torch.complex128 else 1e-4
    assert float(((got - oracle).abs() / oracle.abs()).max()) <= lim


@pytest.mark.parametrize("r, kernel", [
    (6, "K1"), (16, "K1"), (17, "K1"), (linalg.DET_WARP_MAX_R, "K1"),
    (linalg.DET_WARP_MAX_R + 1, "K4"), (32, "K4"), (45, "K4"), (64, "K4")])
def test_size_rule_launches(card, r, kernel):
    A = _well_conditioned(40, r, torch.complex128, card, seed=r)
    k1, k4 = _launches("K1"), _launches("K4")
    linalg.batched_det(A)
    assert (_launches("K1") - k1, _launches("K4") - k4) == (
        (1, 0) if kernel == "K1" else (0, 1))


@pytest.mark.parametrize("make", [
    lambda d: torch.zeros((4, 65, 65), dtype=torch.complex128, device=d),
    lambda d: torch.zeros((4, 45, 46), dtype=torch.complex128,
                          device=d)[:, :, :45],
    lambda d: torch.zeros((4, 45, 45), dtype=torch.float64, device=d),
    lambda d: torch.zeros((45, 45), dtype=torch.complex128, device=d),
], ids=["r65", "non-contiguous", "float64", "unbatched"])
def test_block_wrapper_raises_on_card(card, make):
    from semiclassical_tpu_torch.ops import det_block

    before = _launches("K4")
    with pytest.raises(ValueError):
        det_block.batched_det_block(make(card))
    assert _launches("K4") == before


def test_block_empty_batch_launches_nothing(card):
    from semiclassical_tpu_torch.ops import det_block

    before = _launches("K4")
    got = det_block.batched_det_block(
        torch.empty((0, 45, 45), dtype=torch.complex128, device=card))
    assert got.shape == (0,) and _launches("K4") == before


@pytest.mark.parametrize("bi, bj, r", [(37, 41, 6), (37, 43, 12)],
                         ids=["r6", "r12"])
def test_inv_kernel_at_pair_blocks(card, bi, bj, r):
    """The WM norm's (bi, bj, r, r) pair matrices through
    `linalg.batched_det_inv` (one K3 launch on the flattened batch): bi bj
    = 1517 matrices at r = 6 (5 to a warp) and 1591 at r = 12 (2 to a
    warp) leave the last warp part-filled."""
    A = _well_conditioned(bi * bj, r, torch.complex128, card, seed=bi + r)
    before = _launches("K3")
    det, inv = linalg.batched_det_inv(A.view(bi, bj, r, r))
    torch.cuda.synchronize()
    assert _launches("K3") == before + 1
    assert det.shape == (bi, bj) and inv.shape == (bi, bj, r, r)
    det_p, inv_p = gj.batched_det_inv_gj_plain(A)
    assert float(((det.reshape(-1) - det_p).abs() / det_p.abs()).max()) \
        <= 1e-12
    assert _rel(inv.reshape(-1, r, r), inv_p) <= 1e-12


def _k8_inputs(card, name, n, d, case, steps=20):
    """K8's arguments on the card and the PyTorch chain's results on the
    same rows: a Morse model of d modes, a batch moved `steps` steps
    through the time loop, and then `case`: "whole" the batch's n rows;
    "view" rows 8192:8192 + n of a 98,304-row batch, "view odd" rows 1:1 +
    n; "misaligned" the planes copied one number past a 16-byte boundary.
    HK: (q, p, Z, S, obs_re, obs_im, nacq, previous, signs, diag_k,
    consts) and `chain(m2_mode)`, `hk.hk_observe` as the wrapper returns
    it (C^2, signs, the sums, the moments); WM: (Z, previous, signs,
    diag_k) and `chain()`, `hk_prefactor_det`, `SignTracker.update` and
    `.sqrt()` (C^2, signs, c)."""
    from test_torch_port_graph import _morse, _propagator

    from semiclassical_tpu_torch.propagation import hk

    rows = 98304 if case.startswith("view") else n
    pot, q0, G = _morse(d=d, device=card)
    prop = _propagator(name, pot, q0, G, ntraj=rows, device=card)
    prop.propagate(pot, 2.0, steps, check_energy=False)
    params = prop._loop_params(pot)
    params = params if name == "HK" else params.hk
    a = {"view": 8192, "view odd": 1}.get(case, 0)
    st = hk._batch_rows(prop.state, a, a + n)
    tr = hk._batch_rows(prop.tracker if name == "HK"
                        else prop.tracker.prefactorC, a, a + n)
    bc = hk._batch_rows(prop.bc, a, a + n) if name == "HK" else None
    planes = [st.Z, st.q, st.p]
    if case == "misaligned":
        def off(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
            y = buf[1:].view(x.shape)
            y.copy_(x)
            return y
        planes = [off(x) for x in planes]
    Z, q, p = planes
    if name == "WM":
        def chain():
            ref = tr.update(hk.hk_prefactor_det(params, st))
            return ref.previous, ref.signs, ref.sqrt()
        return (Z, tr.previous, tr.signs, params.diag_k), chain

    def chain(m2_mode):
        ref, *sums = hk.hk_observe(params, st, tr, pot, bc, m2_mode)
        return (ref.previous, ref.signs, *sums)
    return (q, p, Z, st.S, bc.obs_re, bc.obs_im, bc.nacq, tr.previous,
            tr.signs, params.diag_k, hk._k8_consts(params, st)), chain


# K8 against the chain: C^2 (the tracker's new value) within 1e-14 of its
# largest modulus (K8 multiplies the mode terms where the chain sums their
# logs and angles), the signs equal, the sums within 1e-14 of their
# modulus (the batch sums run in another order too), the moments within
# twice that (a square doubles the relative error of a row's term, which
# is the whole sum in a batch of one row)
_K8_RTOL = 1e-14


def _k8_rel(got, ref):
    got, ref = (torch.view_as_real(x) if x.is_complex() else x
                for x in (got, ref))
    return float((got - ref).abs().max() / ref.abs().max())


K8_CASES = [(98304, 60, "whole", "vector"), (8192, 60, "view", "vector"),
            (1000, 61, "view odd", "scalar"), (1001, 61, "whole", "scalar"),
            (1001, 60, "misaligned", "scalar"), (1, 60, "whole", "vector"),
            (130, 130, "whole", "vector")]


@pytest.mark.parametrize("m2_mode", [False, True, "pairs"], ids=str)
@pytest.mark.parametrize("n, d, case, variant", K8_CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}" for c in K8_CASES])
def test_observe_kernel_matches_plain(card, n, d, case, variant, m2_mode):
    """K8's HK observe against the PyTorch chain it replaces
    (`hk.hk_observe`) at the AS model's shape, on a sub-batch's rows of a
    larger batch (at an odd row of an odd d: the scalar variant), at odd
    d, with rows that fill no whole block (1001, 1, 130), on planes one
    number off 16 bytes, and at d = 130 (two passes of a warp over a row):
    one launch a call."""
    from semiclassical_tpu_torch.ops import observe as ob

    if m2_mode == "pairs" and n % 2:
        n -= 1 if n > 1 else -1
    args, chain = _k8_inputs(card, "HK", n, d, case)
    assert ob.layout_of(args[2], args[0], args[1]).variant == variant
    before = _launches("K8")
    got = ob.observe(*args, m2_mode)
    torch.cuda.synchronize()
    assert _launches("K8") == before + 1
    ref = chain(m2_mode)
    assert torch.equal(got[1], ref[1])
    assert _k8_rel(got[0], ref[0]) <= _K8_RTOL
    for i in (2, 3, 4, 5):
        if ref[i] is None:
            assert got[i] is None
        else:
            assert _k8_rel(got[i], ref[i]) <= _K8_RTOL * (1 + (i > 3))


@pytest.mark.parametrize("n, d, case, variant", K8_CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}" for c in K8_CASES])
def test_prefactor_kernel_matches_plain(card, n, d, case, variant):
    """K8's WM prefactor and tracker against the chain it replaces on the
    same cases: C^2 and c within 1e-14 of their largest modulus, the signs
    equal."""
    from semiclassical_tpu_torch.ops import observe as ob

    args, chain = _k8_inputs(card, "WM", n, d, case)
    assert ob.layout_of(args[0]).variant == variant
    before = _launches("K8")
    got = ob.prefactor(*args)
    torch.cuda.synchronize()
    assert _launches("K8") == before + 1
    ref = chain()
    assert torch.equal(got[1], ref[1])
    assert _k8_rel(got[0], ref[0]) <= _K8_RTOL
    assert _k8_rel(got[2], ref[2]) <= _K8_RTOL


def test_observe_kernel_twice_gives_the_same_sums(card):
    """Two launches on the same inputs give the same bits: the blocks'
    counter is back at 0 after each, and the last block's sum of the
    partials runs in a fixed order."""
    from semiclassical_tpu_torch.ops import observe as ob

    args, _ = _k8_inputs(card, "HK", 98304, 60, "whole", steps=5)
    first = ob.observe(*args, True)
    second = ob.observe(*args, True)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_observe_empty_batch_launches_nothing(card):
    from semiclassical_tpu_torch.ops import observe as ob

    args, _ = _k8_inputs(card, "HK", 2, 6, "whole", steps=0)
    args = tuple(x[:, :0] if i == 2 else x[:0] if i < 9 else x
                 for i, x in enumerate(args))
    before = _launches("K8")
    got = ob.observe(*args, True)
    assert _launches("K8") == before
    assert got[0].shape == (0,) and float(got[4]) == 0.0
    assert complex(got[2]) == 0


@pytest.mark.parametrize("case", ["host facs", "cpu signs", "signs apart"])
def test_observe_wrapper_raises_on_card(card, case):
    from semiclassical_tpu_torch.ops import observe as ob

    args = list(_k8_inputs(card, "HK", 16, 6, "whole", steps=0)[0])
    if case == "host facs":
        args[10] = args[10]._replace(fac_i=complex(args[10].fac_i))
    elif case == "cpu signs":
        args[8] = args[8].cpu()
    elif case == "signs apart":
        args[8] = torch.ones(32, dtype=torch.float64, device=card)[::2]
    before = _launches("K8")
    with pytest.raises(ValueError):
        ob.observe(*args, True)
    assert _launches("K8") == before


@pytest.mark.parametrize("name", ["HK", "WM"])
def test_k8_graphs_equal_eager(card, name):
    """HK (with error bars) and WM on a 60-mode Morse model at 1024 x 50
    in segments of 20: graph replays against `graph.eager()` on the same
    draws give C(t), k~ic(t), the stderr and the final tracker bit for bit
    (K8 sums the blocks' partials in a fixed order, with no floating-point
    atomics), and K8 launches once a step in both."""
    import contextlib

    from test_torch_port_graph import _morse, _propagator

    from semiclassical_tpu_torch.propagation import graph

    pot, q0, G = _morse(d=60, device="cuda")
    runs = []
    for eager in (False, True):
        graph.clear()
        prop = _propagator(name, pot, q0, G, ntraj=1024, device="cuda")
        before, stats = _launches("K8"), dict(graph.STATS)
        with graph.eager() if eager else contextlib.nullcontext():
            out = prop.propagate(pot, 2.0, 50, chunk=20,
                                 error_bars=name == "HK")
        torch.cuda.synchronize()
        tracker = prop.tracker if name == "HK" else prop.tracker.prefactorC
        runs.append((out, [tracker.previous.cpu(), tracker.signs.cpu()],
                     _launches("K8") - before,
                     graph.STATS["replays"] - stats["replays"]))
    graph.clear()
    (got, fields, launches, replays), (ref, fields_ref, launches_eager,
                                       _) = runs
    for g, r in zip(got, ref, strict=True):
        assert np.array_equal(g, r)
    for g, r in zip(fields, fields_ref):
        assert torch.equal(g, r)
    assert launches == launches_eager == 50
    assert replays > 0


@pytest.mark.parametrize("name", ["HK", "WM"])
def test_norm_on_card_equals_cpu(card, name):
    """A 3-mode Morse batch of 200 trajectories, 5 steps, the same normals
    on both devices: |psi| on the card equals |psi| on the CPU to 1e-10
    relative, exact and subsampled, at blocks of 64 (4 x 4 block pairs,
    the last one short); the WM norm launches K3 on every block pair."""
    from semiclassical_tpu_torch.potentials import MorsePotential
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    omega = np.array([0.004, 0.0065, 0.009])
    G = np.diag(omega)
    q0 = np.array([0.3, -0.2, 0.25])
    normals = torch.from_numpy(
        np.random.default_rng(3).standard_normal((200, 6)))
    norms = []
    for device in ("cpu", card):
        pot = MorsePotential.create(omega, np.full(3, 0.02),
                                    np.array([0.5, -0.3, 0.8]),
                                    device=device)
        prop = (WaltonManolopoulosPropagator(G, G, 500.0, 500.0,
                                             device=device)
                if name == "WM" else HermanKlukPropagator(G, G,
                                                          device=device))
        prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=200,
                                normals=normals.to(device))
        prop.propagate(pot, 20.0, 5)
        before = _launches("K3")
        exact = prop.norm(block=64)
        launched = _launches("K3") - before
        norms.append((exact, prop.norm(sample_pairs=6, key=2, block=50)))
    (cpu, cpu_sub), (gpu, gpu_sub) = norms
    assert np.isfinite(gpu) and abs(gpu - cpu) < 1e-10 * cpu
    assert abs(gpu_sub[0] - cpu_sub[0]) < 1e-10 * cpu_sub[0]
    assert abs(gpu_sub[1] - cpu_sub[1]) <= 1e-8 * cpu_sub[1]
    if name == "WM":
        # the pair blocks, and the A- and M-matrices of `wm_derived`
        assert launched >= 16
