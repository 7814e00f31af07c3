# coding: utf-8
"""Batched complex determinant: the CUDA kernel K1, its plain version and
its wrapper.

Replaces `semiclassical_tpu/ops/det_kernel.py::pallas_batched_det_lanes`,
the per-step determinant of the dense HK prefactor matrix
(`hk_prefactor_det` -> `linalg.batched_det`), which sends r <=
`linalg.DET_WARP_MAX_R` here (methylium, r = 6) and larger r to K4
(`ops.det_block`, the same elimination with one thread block per matrix,
whose plain version is this module's). Both compute det A for a batch of
complex (n, r, r) matrices by unpivoted right-looking LU in the same pivot
order, with the pivots multiplied into the determinant.

What bounds the kernel (`csrc/det_lu.cu`): at the methylium shape
(n = 10^4, r = 6, complex128) one call reads 5.8 MB and does ~600 flops per
576-byte matrix, about one flop per byte, so it is bound by bytes: a kernel
has to keep many loads in flight and waste few lanes. It has two layouts,
and `det_variant` names the one a size takes:

* the *rows* kernel for r <= `ROWS_MAX_R` = 16: a warp owns 32 // r
  matrices, each lane holds one row of its matrix in registers, a pivot's
  row passes between the lanes of a matrix by shuffle; no shared memory in
  the elimination and no barrier (5 matrices a warp at r = 6);
* the *warp* kernel above: one warp per matrix in shared memory, its lanes
  splitting the entries of each trailing update.

Both read each matrix once, straight from the interleaved re/im layout of
the complex tensor (`torch.view_as_real`: no repacking, no padding, the
kernel masks the ragged edge), and write one complex number per matrix.
The TPU kernel's (r, 2r, tile) trajectory-in-lanes packing and identity
padding are artifacts of the TPU's tiling and are not carried over.

`batched_det` launches the kernel for a tensor on the card and raises on
anything it does not take; it uses the plain version only for a tensor on
the CPU. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["batched_det", "batched_det_lu_plain", "check_det_args",
           "det_variant", "dtype_name", "launch", "LAUNCHES",
           "LAUNCHES_BY_DTYPE", "LAYOUT_CODES", "MAX_R", "ROWS_MAX_R"]

MAX_R = 64
# the rows kernel takes r <= ROWS_MAX_R (a size per compiled instantiation)
ROWS_MAX_R = 16
# the `layout` argument of K1's entry points
LAYOUT_CODES = {"warp": 0, "rows": 1}

# kernel launches made by `batched_det` (plain Python int; one per launch),
# and the same launches by the matrices' dtype name
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"complex128": 0, "complex64": 0}


def batched_det_lu_plain(A: torch.Tensor) -> torch.Tensor:
    """det of a complex (n, r, r) batch by the kernel's unpivoted LU, in
    plain PyTorch: same pivot order, same real arithmetic on the re/im
    parts (reciprocal pivot conj(p)/|p|^2, factors f_i = A[i,k]/p, update
    of the trailing block only)."""
    n, r, _ = A.shape
    a = torch.view_as_real(A.clone())               # (n, r, r, 2)
    det_re = torch.ones(n, dtype=a.dtype, device=a.device)
    det_im = torch.zeros(n, dtype=a.dtype, device=a.device)
    for k in range(r):
        piv_re = a[:, k, k, 0]
        piv_im = a[:, k, k, 1]
        det_re, det_im = (det_re * piv_re - det_im * piv_im,
                          det_re * piv_im + det_im * piv_re)
        if k == r - 1:
            break
        inv_den = 1.0 / (piv_re * piv_re + piv_im * piv_im)
        ip_re = (piv_re * inv_den)[:, None]
        ip_im = (-piv_im * inv_den)[:, None]
        c_re = a[:, k + 1:, k, 0]                    # (n, r-k-1)
        c_im = a[:, k + 1:, k, 1]
        f_re = (c_re * ip_re - c_im * ip_im)[:, :, None]
        f_im = (c_re * ip_im + c_im * ip_re)[:, :, None]
        g_re = a[:, k, k + 1:, 0][:, None, :]        # (n, 1, r-k-1)
        g_im = a[:, k, k + 1:, 1][:, None, :]
        blk_re = a[:, k + 1:, k + 1:, 0]
        blk_im = a[:, k + 1:, k + 1:, 1]
        new_re = blk_re - f_re * g_re + f_im * g_im
        new_im = blk_im - f_re * g_im - f_im * g_re
        a[:, k + 1:, k + 1:, 0] = new_re
        a[:, k + 1:, k + 1:, 1] = new_im
    return torch.complex(det_re, det_im)


def dtype_name(dtype: torch.dtype) -> str:
    """"complex128", "complex64", "float64", ...: the key of the
    `LAUNCHES_BY_DTYPE` counts."""
    return str(dtype).removeprefix("torch.")


def check_det_args(A: torch.Tensor):
    """Raise ValueError unless the kernel takes `A`: complex128 or
    complex64, shape (n, r, r) with 1 <= r <= MAX_R, contiguous. (The
    device is checked by `batched_det`.)"""
    if A.dtype not in (torch.complex128, torch.complex64):
        raise ValueError(f"batched_det takes complex128 or complex64, "
                         f"got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"batched_det takes a (n, r, r) batch, got shape "
                         f"{tuple(A.shape)}")
    if not 1 <= A.shape[1] <= MAX_R:
        raise ValueError(f"batched_det's kernel takes 1 <= r <= {MAX_R}, "
                         f"got r = {A.shape[1]}")
    if not A.is_contiguous():
        raise ValueError("batched_det takes a contiguous tensor")


def det_variant(r: int) -> str:
    """The size rule of K1: the kernel `csrc/det_lu.cu` runs for (r, r)
    matrices in either complex type, "rows" (many matrices per warp, a row
    per lane) for r <= ROWS_MAX_R, "warp" (a warp per matrix in shared
    memory) above."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"K1 takes 1 <= r <= {MAX_R}, got r = {r}")
    return "rows" if r <= ROWS_MAX_R else "warp"


def launch(A: torch.Tensor, kernel: str, *layout: int) -> torch.Tensor:
    """Launch the determinant kernel `kernel` ("det_lu": K1 here, with its
    layout code; "det_lu_block": K4 in `ops.det_block`) on a CUDA tensor
    that `check_det_args` accepted; returns the (n,) determinants. Nothing
    is launched for n = 0; the caller counts its launches."""
    from semiclassical_tpu_torch.ops import _build

    n, r, _ = A.shape
    out = torch.empty(n, dtype=A.dtype, device=A.device)
    if n == 0:
        return out
    err = _build.launch(_build.entry(kernel, A.dtype), A.device,
                        A.data_ptr(), out.data_ptr(), n, r, *layout)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} "
                           f"(n={n}, r={r}, {A.dtype})")
    return out


def batched_det(A: torch.Tensor) -> torch.Tensor:
    """Determinant of a batch of complex matrices, shape (n, r, r) -> (n,).

    A tensor on the card goes to the CUDA kernel (or raises if the kernel
    does not take it); a tensor on the CPU goes to the plain version."""
    global LAUNCHES
    if A.device.type == "cpu":
        return batched_det_lu_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"batched_det runs on cuda or cpu tensors, got "
                         f"{A.device}")
    check_det_args(A)
    out = launch(A, "det_lu", LAYOUT_CODES[det_variant(A.shape[1])])
    if A.shape[0]:
        LAUNCHES += 1
        LAUNCHES_BY_DTYPE[dtype_name(A.dtype)] += 1
    return out
