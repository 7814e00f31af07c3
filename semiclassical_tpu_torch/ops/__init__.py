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
  _build nvcc -> build/kernels/*.so, bound with ctypes; the launch helper
"""
