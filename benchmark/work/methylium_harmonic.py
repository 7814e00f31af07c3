"""Least work of one HK step of methylium on its harmonic PES, per batch
of n trajectories, d = 12 Cartesians, prefactor rank r = 6, float64
trajectories, a constant Hessian.

Bytes: every byte of the state read once and written once a step: q, p
(2 n d), the dense monodromy (n (2d)^2), S, the sign tracker's previous
C^2 (complex) and its sign (4 n), at 8 bytes; the batch constants (4 n)
read once; the constant Hessian (d^2) and the monodromy's step map
((2d)^2) read once a step. There is no window and no per-trajectory
Hessian.

Operations: the step's monodromy product (n (2d)^3 multiply-adds), the
prefactor's two products (n (r 2d 4d + r 4d 2r) multiply-adds, the real
planes of the packed factors, as `coumarin_sgdml` counts them) and its
determinant (`kernels.lu_det`, K1). A multiply-add is 2 operations."""

from work import kernels

D_CART, RANK = 12, 6


def step(task):
    """{"bytes", "flops": {type: operations}} of one step of the whole
    batch: the float64 products on the tensor cores, the determinant
    outside them."""
    n, d, r = int(task["batch_size"]), D_CART, RANK
    state = n * (2 * d + 4 * d * d + 4)
    nbytes = 8 * (2 * state + 4 * n + d * d + 4 * d * d)
    mono = 2 * n * (2 * d) ** 3
    pref = 2 * n * (r * 2 * d * 4 * d + r * 4 * d * 2 * r)
    return {"bytes": nbytes,
            "flops": {"float64_tensor": mono + pref,
                      "float64": k1(task)["flops"]["float64"]}}


def k1(task):
    """K1, the determinant of the (n, r, r) complex128 prefactor
    matrices, once a step."""
    return kernels.lu_det(int(task["batch_size"]), RANK)
