# coding: utf-8
"""Batched complex determinant: the CUDA kernel K1, its plain version and
its wrapper.

Replaces `semiclassical_tpu/ops/det_kernel.py::pallas_batched_det_lanes`,
the per-step determinant of the dense HK prefactor matrix
(`hk_prefactor_det` -> `linalg.batched_det`). Both compute det A for a batch
of complex (n, r, r) matrices by unpivoted right-looking LU in the same
pivot order, with the pivots multiplied into the determinant.

What bounds the kernel (`csrc/det_lu.cu`): at the methylium shape
(n = 10^4, r = 6, complex128) one call reads 5.8 MB and does ~600 flops per
576-byte matrix — about one flop per byte, so it is bound by memory latency
and bytes, not by flops. Its design reads each matrix once, straight from
the interleaved re/im layout of the complex tensor (`torch.view_as_real`:
no repacking, no padding — the kernel masks the ragged edge), eliminates in
shared memory with one warp per matrix, and writes one complex number per
matrix. The TPU kernel's (r, 2r, tile) trajectory-in-lanes packing and
identity padding are artifacts of the TPU's tiling and are not carried over.

`batched_det` launches the kernel for a tensor on the card and raises on
anything it does not take; it uses the plain version only for a tensor on
the CPU. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

__all__ = ["batched_det", "batched_det_lu_plain", "check_det_args",
           "LAUNCHES", "MAX_R"]

MAX_R = 64

# kernel launches made by `batched_det` (plain Python int; one per launch)
LAUNCHES = 0


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


def _launch(A: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    from semiclassical_tpu_torch.ops import _build

    lib = _build.load()
    n, r, _ = A.shape
    out = torch.empty(n, dtype=A.dtype, device=A.device)
    if n == 0:
        return out
    fn = (lib.semi_det_lu_c128 if A.dtype == torch.complex128
          else lib.semi_det_lu_c64)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), out.data_ptr(), n, r, stream)
    if err != 0:
        raise RuntimeError(f"det_lu kernel launch failed: CUDA error {err} "
                           f"(n={n}, r={r}, {A.dtype})")
    LAUNCHES += 1
    return out


def batched_det(A: torch.Tensor) -> torch.Tensor:
    """Determinant of a batch of complex matrices, shape (n, r, r) -> (n,).

    A tensor on the card goes to the CUDA kernel (or raises if the kernel
    does not take it); a tensor on the CPU goes to the plain version."""
    if A.device.type == "cpu":
        return batched_det_lu_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"batched_det runs on cuda or cpu tensors, got "
                         f"{A.device}")
    check_det_args(A)
    return _launch(A)
