# coding: utf-8
"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the build that compiles `csrc/` at first use.

  det    K1: batched complex determinant by unpivoted LU (csrc/det_lu.cu)
  gj     K2: batched det + solve, K3: batched det + inverse, by unpivoted
         Gauss-Jordan (csrc/gj_det.cu)
  wm_diag K5: the fused separable WM chain — per-mode 2x2 A/M algebra,
         mode-sum Gram forms and det planes (csrc/wm_diag.cu)
  _build nvcc -> build/kernels/*.so, bound with ctypes
"""
