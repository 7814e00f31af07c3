"""Least work of one rank's share of the HK norm's pair sum (`propagation.
hk._pair_sum_ring`), sum_ij conj(v_i) <g_i|g_j> v_j over a batch of n
trajectories of d modes shared by `world` ranks, at float64.

Pairs: the n (n + 1) / 2 unordered ones over the ranks. The pair matrix is
Hermitian, so an implementation may sum one triangle; the ring sums every
ordered pair, twice that.

Operations a pair: the exponent's two mode sums, each a product of the
2 d phase-space numbers of one trajectory with 2 d of the other
(4 d multiply-adds, 8 d operations, at the float64 tensor cores' rate, the
fastest a product can take), and one exponential of the pair's term: its
four row and column terms added, exp, cos (the norm is the real part),
one product and the accumulation (8 operations, transcendental functions
one each). Nothing for the row terms, which are O(n).

Bytes: each rank reads every trajectory's q, p and log-coefficient pair
once (8 (2 d + 2) bytes a trajectory)."""

BYTES_PER_NUMBER = 8
MODE_SUM_OPS_PER_MODE = 8
PAIR_OPS = 8


def norm(n, d, world):
    """{"bytes", "flops": {type: operations}} of one norm on one rank."""
    pairs = n * (n + 1) / 2 / world
    return {"bytes": BYTES_PER_NUMBER * n * (2 * d + 2),
            "flops": {"float64_tensor": MODE_SUM_OPS_PER_MODE * d * pairs,
                      "float64": PAIR_OPS * pairs}}
