"""K5's share of its roofline (`ops.wm_diag`, `csrc/wm_diag.cu`, the
fused separable WM chain): its least time at the rows the traced card
steps (`work/<config>.py` `k5`: ten (n, d) planes read, four and 30 sums
a row written, bytes over the card's bandwidth against its operations
over the peak of its type; n the task's batch or a rank's share of it in
a group), times its launches, over its device time in the traced window,
by kernel name. Nothing where the window holds no K5 launch (a dense WM
path, an HK cell) or the card is not in the peaks table."""

from semibench import cell, peaks

KERNEL = "wm_diag_kernel"


def read(run):
    t, peak = run.trace, peaks.of(run.device)
    if t is None or peak is None:
        return None
    names = [n for n in t.op_s if KERNEL in n]
    seconds = sum(t.op_s[n] for n in names)
    if not seconds:
        return None
    calls = sum(t.op_n[n] for n in names)
    task = cell.rank_task(run.cell.task, run.world)
    least = peaks.least_seconds(run.cell.work().k5(task), peak)
    return 100.0 * calls * least / seconds
