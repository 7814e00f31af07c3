# coding: utf-8
"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the build that compiles `csrc/` at first use.

  det    K1: batched complex determinant by unpivoted LU (csrc/det_lu.cu)
  _build nvcc -> build/kernels/*.so, bound with ctypes
"""
