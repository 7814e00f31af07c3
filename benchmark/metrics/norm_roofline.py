"""The norm's share of its roofline: the least time of one rank's share of
the pair sum (`work/pair_norm.py`: the larger of its bytes over the card's
bandwidth and its operations over the peaks of `peaks.json`) over
`norm_ms`, the mean time a norm of the window's repetitions. Nothing where
the run takes no norms or the card is not in the peaks table."""

from metrics import norm_ms
from semibench import peaks
from work import pair_norm


def read(run):
    ms = norm_ms.read(run)
    peak = peaks.of(run.device)
    if ms is None or peak is None:
        return None
    task = run.cell.task
    work = pair_norm.norm(int(task["batch_size"]),
                          int(task["potential"]["model"]["num_modes"]),
                          run.world)
    return 100.0 * peaks.least_seconds(work, peak) / (ms / 1e3)
