"""The norm: the harness's span around each `propagator.norm()` of the
window's repetitions (the ring pair sum over every ordered pair of the
batch under a group, `propagation.hk._pair_sum_ring`, with its ring shifts
and its all-reduce), the card synchronised at its end, on rank 0; mean ms
a norm. Nothing in a cell that takes no norms. Host clock."""


def read(run):
    done = [r for r in run.timed if r.get("norm_n")]
    count = sum(r["norm_n"] for r in done)
    return 1e3 * sum(r["norm_s"] for r in done) / count if count else None
