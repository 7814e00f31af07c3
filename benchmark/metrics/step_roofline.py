"""The whole step's share of its roofline: the least time a step can
take (the larger of its least bytes over the card's memory bandwidth and
its least operations over its peak rate at the step's type, from the
configuration's shapes in `work/<config>.py`), over the traced run's
`scan_ms_per_step` (its window's untraced repetitions). Nothing where the card is not in the peaks table."""

from metrics import scan_ms_per_step
from semibench import peaks


def read(run):
    ms = scan_ms_per_step.read(run)
    peak = peaks.of(run.device)
    if ms is None or peak is None:
        return None
    work = run.cell.work().step(run.cell.task)
    return 100.0 * peaks.least_seconds(work, peak) / (ms / 1e3)
