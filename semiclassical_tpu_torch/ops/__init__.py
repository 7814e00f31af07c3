# coding: utf-8
"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the build that compiles `csrc/` at first use.

  det    K1: batched complex determinant by unpivoted LU, many matrices
         per warp (r <= 16) or one warp per matrix (csrc/det_lu.cu)
  det_block K4: the same determinant, one thread block per matrix, for
         the larger r to 64 (csrc/det_lu_block.cu)
  gj     K2: batched det + solve, K3: batched det + inverse, by unpivoted
         Gauss-Jordan (csrc/gj_det.cu; csrc/rows.cuh is shared with K1)
  wm_diag K5: the fused separable WM chain — per-mode 2x2 A/M algebra,
         mode-sum Gram forms and det planes (csrc/wm_diag.cu)
  diag_mono K6: the RK4 step of the diagonal monodromy, one streaming
         pass over the (n, d) planes (csrc/diag_mono.cu)
  morse_rk4 K7: the RK4 trajectory step of a separable Morse PES, the four
         stages in registers, writing the stage Hessian diagonals K6 reads
         (csrc/morse_rk4.cu)
  _build nvcc -> build/kernels/*.so, bound with ctypes; the one launch
         path: every launch, its CUDA error check and its count in one
         table, read by label with `launch_counts()` and emptied with
         `reset_launch_counts()`

A new kernel is a `csrc/*.cu` source, one row of `_build._ENTRY_POINTS`
(its label, types and argument types) and its wrapper module here.
"""

from semiclassical_tpu_torch.ops._build import (LAUNCHES, launch_counts,
                                                reset_launch_counts)

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts"]
