"""The whole step's share of its roofline: the least time a step can
take (the larger of its least bytes over the card's memory bandwidth and
its least operations over its peak rate at the step's type, from the
configuration's shapes in `work/<config>.py`, for the rows one card
steps: a rank's share of the batch in a group), over the traced run's
`scan_ms_per_step` (its window's untraced repetitions, the norms left
out). Nothing where the card is not in the peaks table."""

from metrics import scan_ms_per_step
from semibench import cell, peaks


def read(run):
    ms = scan_ms_per_step.read(run)
    peak = peaks.of(run.device)
    if ms is None or peak is None:
        return None
    work = run.cell.work().step(cell.rank_task(run.cell.task,
                                                run.world))
    return 100.0 * peaks.least_seconds(work, peak) / (ms / 1e3)
