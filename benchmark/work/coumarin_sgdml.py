"""Least work of one HK step of coumarin on its sGDML force field, per
batch of n trajectories, d = 51 Cartesians, prefactor rank r = 45, a
window of `taylor_every` steps, float64 trajectories and float32 Hessian.

Bytes: every byte of the state read once and written once a step: q, p
(2 n d), the dense monodromy (n (2d)^2), S, the sign tracker's previous
C^2 (complex) and its sign (4 n), at 8 bytes; the window's monodromy map
(n (2d)^2 at 8 bytes) read once a step; its float32 Hessian (n d^2 at 4
bytes) read once a step; the batch constants (4 n) read once.

Operations: the step's monodromy product (n (2d)^3 multiply-adds), the
prefactor's two products (n (r 2d 4d + r 4d 2r) multiply-adds, the real
planes of the packed factors) and its determinant (`kernels.lu_det`),
and, once a window, the force field's float32 Hessian: its three (M, D) x (D, d)
products and two (d, M) x (M, d) ones at the Hessian's type (M = 200
training descriptors, D = 136 pairs), amortised over the window. A
multiply-add is 2 operations. A WM step adds its three Gauss-Jordan
eliminations (K2 at (n, 45, 45 | 90), (| 45), (| 5), `kernels.gj_solve`),
bytes and operations, and nothing for the rest of its A and M algebra."""

from work import kernels

D_CART, RANK, M_TRAIN, D_PAIRS = 51, 45, 200, 136


def step(task):
    """{"bytes", "flops": {type: operations}} of one step of the whole
    batch: the float64 products on the tensor cores, the determinant
    outside them, the float32 Hessian products outside them."""
    n, d, r = int(task["batch_size"]), D_CART, RANK
    every = int(task["potential"].get("taylor_every", 1))
    state = n * (2 * d + 4 * d * d + 4)
    nbytes = (8 * (2 * state + n * 4 * d * d + 4 * n) + 4 * n * d * d)
    mono = 2 * n * (2 * d) ** 3
    pref = 2 * n * (r * 2 * d * 4 * d + r * 4 * d * 2 * r)
    det = kernels.lu_det(n, r)["flops"]["float64"]
    hess = 2 * n * (3 * M_TRAIN * D_PAIRS * d + 2 * d * M_TRAIN * d) / every
    if task.get("propagator", "HK") == "WM":
        for w in k2(task):
            nbytes += w["bytes"]
            det += w["flops"]["float64"]
    return {"bytes": nbytes, "flops": {"float64_tensor": mono + pref,
                                       "float64": det, "float32": hess}}


def k4(task):
    """K4, the determinant of the (n, r, r) complex128 prefactor
    matrices, once a step."""
    return kernels.lu_det(int(task["batch_size"]), RANK)


# K2's (m, k) a WM step launches at rank r = 45, once each
K2_SHAPES = ((RANK, 2 * RANK), (RANK, RANK), (RANK, 5))


def k2(task):
    """K2's three eliminations of a WM step, complex128."""
    n = int(task["batch_size"])
    return [kernels.gj_solve(n, m, k) for m, k in K2_SHAPES]
