"""Least work of the port's hand-written kernels at a shape, counted as
the bring-up checks count it: each input byte read once and each output
byte written once; the unpivoted LU's and Gauss-Jordan's operations,
complex multiply-adds at 8 real operations, scalings at 6, a reciprocal
at 12, held to the peak rate outside the tensor cores of their type."""


def _type(complex_bytes):
    return "float64" if complex_bytes == 16 else "float32"


def lu_det(n, r, complex_bytes=16):
    """K1 / K4: determinants of n (r, r) complex matrices."""
    flops = n * sum(8 * (r - k - 1) ** 2 + 6 * (r - k - 1) + 12
                    for k in range(r))
    return {"bytes": n * (r * r + 1) * complex_bytes,
            "flops": {_type(complex_bytes): flops}}


def gj_solve(n, m, k, complex_bytes=16):
    """K2: Gauss-Jordan on [A | B] for n systems of m equations and k
    right-hand sides, with det A."""
    flops = n * sum(6 * (m + k - p - 1) + 8 * (m - 1) * (m + k - p - 1)
                    + 12 for p in range(m))
    return {"bytes": n * (m * m + 2 * m * k + 1) * complex_bytes,
            "flops": {_type(complex_bytes): flops}}
