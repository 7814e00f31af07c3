# coding: utf-8
"""K5's layout rule (`ops.wm_diag.layout`, `layout_of`) on the CPU.

The rule picks the variant of csrc/wm_diag.cu that a batch of (n, d)
planes runs: modes per lane (`vec`, one vector access), lanes per row,
rows per block and blocks. The card is not needed: these tests walk the
kernel's loop over a row (`_kernel_modes`, lane g reads modes j .. j + vec
- 1 for j = g vec, g vec + lanes vec, ... below d) for every d the kernel
takes and hold the rule to what the kernel assumes. No JAX counterpart
exists, so nothing here imports JAX.
"""

import pytest
import torch

from semiclassical_tpu_torch.ops import wm_diag

DTYPES = (torch.float64, torch.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kernel_modes(lay, d):
    """The modes each lane of a row reads, as the kernel's loop walks
    them."""
    return [[j + e for j in range(g * lay.vec, d, lay.lanes * lay.vec)
             for e in range(lay.vec)] for g in range(lay.lanes)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunks_cover_every_mode_once(dtype, aligned):
    """For every 1 <= d <= 256 the lanes of a row read each mode exactly
    once, in vectors of at most 16 bytes that d divides (pairs wherever d is
    even and the planes aligned); the block's lanes make whole rows, and
    its shared memory (the constant pack) fits the 48 KiB a launch takes
    without opting in, well inside the H100's 232,448 bytes."""
    size = torch.finfo(dtype).bits // 8
    for d in range(1, wm_diag.MAX_D + 1):
        lay = wm_diag.layout(1000, d, dtype, aligned)
        modes = sorted(m for lane in _kernel_modes(lay, d) for m in lane)
        assert modes == list(range(d)), (d, lay)
        assert d % lay.vec == 0 and lay.vec * size <= 16
        assert lay.variant == ("vector" if lay.vec > 1 else "scalar")
        assert lay.vec == (2 if aligned and d % 2 == 0 else 1)
        assert lay.lanes in (4, 8, 16) and lay.rows * lay.lanes == 256
        assert lay.smem == len(wm_diag.CONSTS) * d * size
        assert lay.smem <= wm_diag.MAX_SMEM < 232448


@pytest.mark.parametrize("dtype", DTYPES)
def test_flagship_layout(dtype):
    """The 60-mode AS batch: pairs of modes, 16 lanes a row, two passes
    (14 of 16 lanes busy in the second), 16 rows a block."""
    lay = wm_diag.layout(98304, 60, dtype, True)
    size = torch.finfo(dtype).bits // 8
    assert lay == wm_diag.Layout("vector", 16, 16, 2, 17 * 60 * size, 6144)
    lanes = _kernel_modes(lay, 60)
    assert max(len(m) for m in lanes) == 4
    assert sum(len(m) == 4 for m in lanes) == 14


@pytest.mark.parametrize("n", [0, 1, 31, 1001, 98305])
@pytest.mark.parametrize("d", [1, 5, 60, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocks_cover_every_row(dtype, d, n):
    """The blocks' rows cover the batch, and no block is left without a
    row."""
    lay = wm_diag.layout(n, d, dtype, True)
    assert lay.blocks * lay.rows >= n
    assert (lay.blocks - 1) * lay.rows < max(n, 1)


def test_offset_views_take_the_scalar_variant():
    """Planes that do not start on a 16-byte boundary take the scalar
    variant: Z[1] of a (4, n, d) float32 tensor at an odd n d, or a narrowed
    flat tensor; the aligned tensors themselves take vectors where d
    allows."""
    Z = torch.zeros((4, 1001, 6), dtype=torch.float32)
    assert wm_diag.layout_of([Z[0]] * 10).vec == 2
    assert Z[1].data_ptr() % 16 == 8
    assert wm_diag.layout_of([Z[0], Z[1], *[Z[0]] * 8]).variant == "scalar"
    Z5 = torch.zeros((4, 1001, 5), dtype=torch.float32)
    assert wm_diag.layout_of([*Z5, *[Z5[0]] * 6]).variant == "scalar"
    flat = torch.zeros(1 + 1001 * 60, dtype=torch.float32)
    good = torch.zeros((1001, 60), dtype=torch.float32)
    assert wm_diag.layout_of([good] * 10).variant == "vector"
    narrowed = flat.narrow(0, 1, 1001 * 60).view(1001, 60)
    assert wm_diag.layout_of([good] * 9 + [narrowed]).variant == "scalar"
    Z64 = torch.zeros((4, 1001, 5), dtype=torch.float64)
    assert Z64[1].data_ptr() % 16 == 8
    assert wm_diag.layout_of([*Z64, *[Z64[0]] * 6]).variant == "scalar"


@pytest.mark.parametrize("d", [0, 257])
def test_layout_refuses_d_out_of_range(d):
    with pytest.raises(ValueError):
        wm_diag.layout(10, d, torch.float64, True)


def test_layout_refuses_other_types():
    with pytest.raises(ValueError):
        wm_diag.layout(10, 8, torch.complex64, True)
    with pytest.raises(ValueError):
        wm_diag.layout(-1, 8, torch.float32, True)
