# coding: utf-8
"""Batched complex Gauss-Jordan eliminations: the CUDA kernels K2
(det + solve) and K3 (det + inverse), their plain versions and their
wrappers.

K2 replaces `semiclassical_tpu/ops/det_kernel.py::
pallas_batched_det_solve_lanes`: (det A, A^{-1} B) for A (n, m, m) and
B (n, m, k) by unpivoted augmented Gauss-Jordan on [A | B], updating only
the live columns (A columns right of the pivot and every B column). It
carries the WM fast path: three calls per step (`linalg.
batched_det_solve_blocks` on the balanced A-matrix, `linalg.
batched_det_solve` on the M-matrix).

K3 replaces `pallas_batched_det_inv_lanes`: (det A, A^{-1}) for
A (n, m, m) by in-place unpivoted Gauss-Jordan, column k collecting the
inverse factors. It builds the WM trackers (`wm_derived`, twice per batch).

Both eliminate in the TPU kernels' pivot order with the same complex
arithmetic (reciprocal pivot conj(p)/|p|^2, rank-1 row updates).

What bounds the kernels at the large leaves is the chain of m pivots, each
waiting on the update before it, not the flops or bytes of a call; with the
matrix in shared memory every update adds three shared loads and a store to
that chain. So `csrc/gj_det.cu` keeps the matrix in registers and passes
only a pivot's row and its column between threads. The small matrices
(m <= 16) are bound by bytes: there a kernel has to waste few lanes and
keep many loads in flight. K2 has two layouts, and `solve_variant` names
the one a shape takes:

* the *block* kernel: 8 or 16 warps own one matrix [A | B_c], B_c one of
  `chunks` column chunks of B; warps over rows, lanes over columns, a
  `tile_rows` x `tile_cols` register tile per thread; a pivot's row and
  column go through a few KB of double-buffered shared memory, one barrier
  per pivot (coumarin's m = 45 leaves, the flagship's (60 | 120));
* the *warp* kernel for m <= 8 and m + k <= 64: one warp owns a matrix of
  at most 8 KB in shared memory, eight warps to a block (methylium's m = 6
  leaves; a register-and-shuffle version measured slower there, PERF.md).

K3 has two as well, named by `inv_variant`:

* the *block* kernel for m > `ROWS_MAX_M` = 16: K2's block layout on A
  alone (a mode of the same kernel), every column live, a `tile_rows` x
  ceil(m / 32) tile per thread (6 x 2 at coumarin's m = 45, 4 warps per
  matrix to m = 32, 8 or 16 above); the threads that hold the pivot's
  column overwrite it with the inverse's factors after each update;
* the *rows* kernel for m <= 16: a warp owns 32 // m matrices, each lane
  holds one row of its matrix in registers, the pivot row passes between
  the lanes of a matrix by shuffle; no shared memory in the elimination,
  no barrier (methylium's trackers at m = 12 and 6, and the (r, r) pair
  blocks of a WM norm).

All read the complex tensors in place through their interleaved re/im
layout.

The wrappers launch the kernel for tensors on the card and raise on
anything it does not take; they use the plain version only for tensors on
the CPU. There is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["batched_det_solve_gj", "batched_det_inv_gj",
           "batched_det_solve_gj_plain", "batched_det_inv_gj_plain",
           "check_solve_args", "check_inv_args", "solve_variant",
           "inv_variant", "SolveVariant", "InvVariant", "LAUNCHES", "MAX_M",
           "MAX_WIDTH", "WARP_MAX_M", "WARP_MAX_WIDTH", "ROWS_MAX_M"]

MAX_M = 64        # rows (and A columns) a kernel takes
MAX_WIDTH = 192   # m + k of K2's augmented matrix

# K2's warp kernel takes m <= WARP_MAX_M rows and m + k <= WARP_MAX_WIDTH
WARP_MAX_M = 8
WARP_MAX_WIDTH = 64
# K3's rows kernel takes m <= ROWS_MAX_M (a size per compiled instantiation)
ROWS_MAX_M = 16

# kernel launches made by the wrappers, per kernel (one per launch)
LAUNCHES = {"det_solve": 0, "det_inv": 0}


class SolveVariant(NamedTuple):
    """The layout K2 gives a shape: `kind` "warp" (one warp per matrix in
    shared memory, `warps` = 1, no tile) or "block" (`warps` warps per
    matrix and chunk, a thread holding `tile_rows` x `tile_cols` entries in
    registers, B cut into `chunks` column chunks, each eliminated with A by
    a block of its own)."""
    kind: str
    warps: int
    tile_rows: int
    tile_cols: int
    chunks: int


class InvVariant(NamedTuple):
    """The layout K3 gives a size: `kind` "rows" (many matrices per warp, a
    row per lane, `warps` = 0, no tile) or "block" (`warps` warps per
    matrix, a thread holding `tile_rows` x `tile_cols` entries in
    registers)."""
    kind: str
    warps: int
    tile_rows: int
    tile_cols: int


# K2's block layouts by rows: (largest m, warps, tile rows, widest tile in
# columns). A thread holds at most 18 entries (72 registers in complex128),
# so that two blocks of 8 warps, or one of 16, fit an SM's registers.
_BLOCK_ROWS = ((16, 8, 2, 6), (32, 8, 4, 4), (48, 8, 6, 3), (64, 16, 4, 4))
# K3's block layouts by rows: (largest m, warps, tile rows); the tile is as
# wide as the matrix. To m = 32 a matrix gets four warps: sixteen blocks
# share an SM and overlap their pivot chains (8 warps measured 1.03-1.6x
# slower there on an H100, PERF.md); above, K2's warps and tile rows.
_INV_BLOCK_ROWS = ((20, 4, 5), (24, 4, 6), (28, 4, 7), (32, 4, 8),
                   (48, 8, 6), (64, 16, 4))
_LANES = 32


def _ceil_div(a, b):
    return -(-a // b)


def solve_variant(m: int, k: int) -> SolveVariant:
    """The size rule of K2: the layout `csrc/gj_det.cu` runs for A (m, m),
    B (m, k), in either complex type. m <= 8 with m + k <= 64 takes the
    warp kernel; anything else the block kernel, with warps and tile rows
    by m and B in the fewest chunks whose [A | B_c] fits the widest tile
    (coumarin's (45 | 90) runs as two chunks of (45 | 45))."""
    if not (1 <= m <= MAX_M and k >= 1 and m + k <= MAX_WIDTH):
        raise ValueError(f"K2 takes 1 <= m <= {MAX_M}, k >= 1 and m + k <= "
                         f"{MAX_WIDTH}, got (m | k) = ({m} | {k})")
    if m <= WARP_MAX_M and m + k <= WARP_MAX_WIDTH:
        return SolveVariant("warp", 1, 0, 0, 1)
    warps, tile_rows, max_cols = next(row[1:] for row in _BLOCK_ROWS
                                      if m <= row[0])
    chunks = _ceil_div(k, _LANES * max_cols - m)
    widest = m + _ceil_div(k, chunks)
    return SolveVariant("block", warps, tile_rows, _ceil_div(widest, _LANES),
                        chunks)


def inv_variant(m: int) -> InvVariant:
    """The size rule of K3: the layout `csrc/gj_det.cu` runs for A (m, m)
    in either complex type. m <= ROWS_MAX_M takes the rows kernel; anything
    else the block kernel, with warps and tile rows by m and a tile as wide
    as the matrix (coumarin's m = 45 runs as 8 warps of 6 x 2 tiles)."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"K3 takes 1 <= m <= {MAX_M}, got m = {m}")
    if m <= ROWS_MAX_M:
        return InvVariant("rows", 0, 0, 0)
    warps, tile_rows = next(row[1:] for row in _INV_BLOCK_ROWS
                            if m <= row[0])
    return InvVariant("block", warps, tile_rows, _ceil_div(m, _LANES))


def _cmul(x_re, x_im, y_re, y_im):
    return x_re * y_re - x_im * y_im, x_re * y_im + x_im * y_re


def _recip(p_re, p_im):
    """conj(p) / |p|^2 as (re, im)."""
    inv_den = 1.0 / (p_re * p_re + p_im * p_im)
    return p_re * inv_den, -p_im * inv_den


def batched_det_solve_gj_plain(A: torch.Tensor, B: torch.Tensor):
    """(det A, A^{-1} B) for A (n, m, m), B (n, m, k) by K2's unpivoted
    augmented Gauss-Jordan, in plain PyTorch: same pivot order, same real
    arithmetic on the re/im parts, live columns only."""
    n, m, _ = A.shape
    a = torch.view_as_real(torch.cat([A, B], dim=2))    # (n, m, w, 2) copy
    det_re = torch.ones(n, dtype=a.dtype, device=a.device)
    det_im = torch.zeros(n, dtype=a.dtype, device=a.device)
    for kp in range(m):
        p_re, p_im = a[:, kp, kp, 0], a[:, kp, kp, 1]
        det_re, det_im = _cmul(det_re, det_im, p_re, p_im)
        ip_re, ip_im = _recip(p_re[:, None], p_im[:, None])
        # scaled pivot row over the live columns kp+1 .. w-1
        rs_re, rs_im = _cmul(a[:, kp, kp + 1:, 0], a[:, kp, kp + 1:, 1],
                             ip_re, ip_im)                # (n, live)
        c_re = a[:, :, kp, 0][:, :, None]                 # (n, m, 1)
        c_im = a[:, :, kp, 1][:, :, None]
        x_re, x_im = a[:, :, kp + 1:, 0], a[:, :, kp + 1:, 1]
        # rank-1 update of all rows (row kp becomes ~0 and is restored);
        # column kp is not live, so c is not overwritten
        new_re = x_re - c_re * rs_re[:, None] + c_im * rs_im[:, None]
        new_im = x_im - c_re * rs_im[:, None] - c_im * rs_re[:, None]
        a[:, :, kp + 1:, 0] = new_re
        a[:, :, kp + 1:, 1] = new_im
        a[:, kp, kp + 1:, 0] = rs_re
        a[:, kp, kp + 1:, 1] = rs_im
    sol = torch.view_as_complex(a[:, :, m:, :].contiguous())
    return torch.complex(det_re, det_im), sol


def batched_det_inv_gj_plain(A: torch.Tensor):
    """(det A, A^{-1}) for A (n, m, m) by K3's unpivoted in-place
    Gauss-Jordan, in plain PyTorch: same pivot order, same real arithmetic
    on the re/im parts."""
    n, m, _ = A.shape
    a = torch.view_as_real(A.clone())                     # (n, m, m, 2)
    det_re = torch.ones(n, dtype=a.dtype, device=a.device)
    det_im = torch.zeros(n, dtype=a.dtype, device=a.device)
    for kp in range(m):
        p_re, p_im = a[:, kp, kp, 0], a[:, kp, kp, 1]
        det_re, det_im = _cmul(det_re, det_im, p_re, p_im)
        ip_re, ip_im = _recip(p_re, p_im)
        rs_re, rs_im = _cmul(a[:, kp, :, 0], a[:, kp, :, 1],
                             ip_re[:, None], ip_im[:, None])   # (n, m)
        c_re = a[:, :, kp, 0].clone()                     # (n, m)
        c_im = a[:, :, kp, 1].clone()
        new_re = (a[..., 0] - c_re[:, :, None] * rs_re[:, None]
                  + c_im[:, :, None] * rs_im[:, None])
        new_im = (a[..., 1] - c_re[:, :, None] * rs_im[:, None]
                  - c_im[:, :, None] * rs_re[:, None])
        a[..., 0] = new_re
        a[..., 1] = new_im
        a[:, kp, :, 0] = rs_re
        a[:, kp, :, 1] = rs_im
        # column kp collects -c / p, the pivot entry 1 / p
        f_re, f_im = _cmul(c_re, c_im, ip_re[:, None], ip_im[:, None])
        a[:, :, kp, 0] = -f_re
        a[:, :, kp, 1] = -f_im
        a[:, kp, kp, 0] = ip_re
        a[:, kp, kp, 1] = ip_im
    return torch.complex(det_re, det_im), torch.view_as_complex(a)


def _check_square(name, A):
    if A.dtype not in (torch.complex128, torch.complex64):
        raise ValueError(f"{name} takes complex128 or complex64, got "
                         f"{A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name} takes a (n, m, m) batch, got shape "
                         f"{tuple(A.shape)}")
    if not 1 <= A.shape[1] <= MAX_M:
        raise ValueError(f"{name}'s kernel takes 1 <= m <= {MAX_M}, got "
                         f"m = {A.shape[1]}")
    if not A.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")


def check_solve_args(A: torch.Tensor, B: torch.Tensor):
    """Raise ValueError unless K2 takes (A, B): complex128 or complex64 of
    one type, A (n, m, m) with 1 <= m <= MAX_M, B (n, m, k) with k >= 1 and
    m + k <= MAX_WIDTH, both contiguous on one device."""
    name = "batched_det_solve_gj"
    _check_square(name, A)
    if B.dtype != A.dtype:
        raise ValueError(f"{name} takes A and B of one type, got {A.dtype} "
                         f"and {B.dtype}")
    n, m, _ = A.shape
    if B.dim() != 3 or B.shape[:2] != (n, m) or B.shape[2] < 1:
        raise ValueError(f"{name} takes B of shape (n, m, k) = ({n}, {m}, k "
                         f">= 1), got {tuple(B.shape)}")
    if m + B.shape[2] > MAX_WIDTH:
        raise ValueError(f"{name}'s kernel takes m + k <= {MAX_WIDTH}, got "
                         f"m + k = {m + B.shape[2]}")
    if not B.is_contiguous():
        raise ValueError(f"{name} takes contiguous tensors")
    if B.device != A.device:
        raise ValueError(f"{name} takes A and B on one device, got "
                         f"{A.device} and {B.device}")


def check_inv_args(A: torch.Tensor):
    """Raise ValueError unless K3 takes `A`: complex128 or complex64,
    (n, m, m) with 1 <= m <= MAX_M, contiguous."""
    _check_square("batched_det_inv_gj", A)


def _raise_on(err, kernel, A):
    if err != 0:
        raise RuntimeError(f"gj_{kernel} kernel launch failed: CUDA error "
                           f"{err} (shape {tuple(A.shape)}, {A.dtype})")


def _launch_solve(A, B):
    from semiclassical_tpu_torch.ops import _build

    n, m, _ = A.shape
    det = torch.empty(n, dtype=A.dtype, device=A.device)
    sol = torch.empty_like(B)
    if n == 0:
        return det, sol
    err = _build.launch(
        _build.entry("gj_det_solve", A.dtype), A.device, A.data_ptr(),
        B.data_ptr(), sol.data_ptr(), det.data_ptr(), n, m, B.shape[2],
        *solve_variant(m, B.shape[2])[1:])
    _raise_on(err, "det_solve", A)
    LAUNCHES["det_solve"] += 1
    return det, sol


def _launch_inv(A):
    from semiclassical_tpu_torch.ops import _build

    n, m, _ = A.shape
    det = torch.empty(n, dtype=A.dtype, device=A.device)
    inv = torch.empty_like(A)
    if n == 0:
        return det, inv
    err = _build.launch(
        _build.entry("gj_det_inv", A.dtype), A.device, A.data_ptr(),
        inv.data_ptr(), det.data_ptr(), n, m, *inv_variant(m)[1:])
    _raise_on(err, "det_inv", A)
    LAUNCHES["det_inv"] += 1
    return det, inv


def _route(name, *tensors):
    """'cpu' when every tensor is on the CPU, 'cuda' when every one is on
    the card; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        return kinds.pop()
    raise ValueError(f"{name} runs on cuda or cpu tensors (all on one), got "
                     f"{', '.join(str(t.device) for t in tensors)}")


def batched_det_solve_gj(A: torch.Tensor, B: torch.Tensor):
    """(det A, A^{-1} B) for A (n, m, m), B (n, m, k) -> ((n,), (n, m, k)).

    Tensors on the card go to K2 (or raise if it does not take them);
    tensors on the CPU go to the plain version."""
    if _route("batched_det_solve_gj", A, B) == "cpu":
        return batched_det_solve_gj_plain(A, B)
    check_solve_args(A, B)
    return _launch_solve(A, B)


def batched_det_inv_gj(A: torch.Tensor):
    """(det A, A^{-1}) for A (n, m, m) -> ((n,), (n, m, m)).

    A tensor on the card goes to K3 (or raises if it does not take it); a
    tensor on the CPU goes to the plain version."""
    if _route("batched_det_inv_gj", A) == "cpu":
        return batched_det_inv_gj_plain(A)
    check_inv_args(A)
    return _launch_inv(A)
