# coding: utf-8
"""Batched complex determinant with one thread block per matrix: the CUDA
kernel K4, its plain version and its wrapper.

Replaces `semiclassical_tpu/ops/det_kernel.py::pallas_batched_det` (kernel
body `_lu_det_kernel`): det A for a batch of complex (n, r, r) matrices by
unpivoted right-looking LU in K1's pivot order, with the pivots multiplied
into the determinant. `linalg.batched_det` sends `linalg.DET_WARP_MAX_R`
< r <= 64 here (the sGDML prefactor, r = 45 on coumarin) and smaller r to
K1 (`ops.det`), whose kernels give a matrix a warp or a part of one.

What bounds the kernel (`csrc/det_lu_block.cu`): at (2048, 45, 45)
complex128 one call reads 66.4 MB and does 0.49 GFLOP, so bytes and FP64
throughput are within a factor 1.4 of each other; what a block waits on is
the chain of its r pivots. The design gives each matrix a block of 16 x 16
threads, each holding a fixed register tile of the matrix (rows and columns
dealt cyclically, 3 x 3 entries at r = 45) across all pivots; per pivot only
the pivot row, the pivot column and the reciprocal pivot pass through
shared memory, with one barrier, and three blocks share an SM and overlap
their chains. It reads the interleaved re/im layout in place and writes one
complex number per matrix (times in PERF.md).

The elimination is K1's, so the plain version is `ops.det`'s
`batched_det_lu_plain`, re-exported here. `batched_det_block` launches the
kernel for a tensor on the card and raises on anything it does not take;
it uses the plain version only for a tensor on the CPU. There is no
fallback to the plain version or to K1.
"""

from __future__ import annotations

import torch

from semiclassical_tpu_torch.ops.det import (MAX_R, batched_det_lu_plain,
                                             check_det_args, dtype_name,
                                             launch)

__all__ = ["batched_det_block", "batched_det_lu_plain", "LAUNCHES",
           "LAUNCHES_BY_DTYPE", "MAX_R"]

# kernel launches made by `batched_det_block` (plain Python int)
LAUNCHES = 0
# the same launches by the matrices' dtype name
LAUNCHES_BY_DTYPE = {"complex128": 0, "complex64": 0}


def batched_det_block(A: torch.Tensor) -> torch.Tensor:
    """Determinant of a batch of complex matrices, shape (n, r, r) -> (n,).

    A tensor on the card goes to the CUDA kernel K4 (or raises if the
    kernel does not take it); a tensor on the CPU goes to the plain
    version."""
    global LAUNCHES
    if A.device.type == "cpu":
        return batched_det_lu_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"batched_det_block runs on cuda or cpu tensors, "
                         f"got {A.device}")
    check_det_args(A)
    out = launch(A, "det_lu_block")
    if A.shape[0]:
        LAUNCHES += 1
        LAUNCHES_BY_DTYPE[dtype_name(A.dtype)] += 1
    return out
