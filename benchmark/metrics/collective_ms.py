"""The process group's collectives (`parallel.group`: the segments'
all-reduce `group_sum`, the norm's `ring_shift` and its all-reduce): the
device time of the kernels whose names begin with `nccl` in rank 0's
traced repetition, ms a repetition, waits for the other ranks included.
Nothing where the trace holds no such kernel (a single process)."""

PREFIX = "nccl"


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds = sum(s for name, s in t.op_s.items()
                  if name.lower().startswith(PREFIX))
    return 1e3 * seconds if seconds else None
