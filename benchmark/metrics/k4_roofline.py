"""K4's share of its roofline (`ops.det_block`, `csrc/det_lu_block.cu`):
its least time at the cell's (n, 45, 45) complex128 shape
(`work/<config>.py` `k4`, bytes and LU operations) times its launches,
over its device time in the traced window, by kernel name. Nothing where
the window holds no K4 launch or the card is not in the peaks table."""

from semibench import peaks

KERNEL = "det_lu_block_kernel"


def read(run):
    t, peak = run.trace, peaks.of(run.device)
    if t is None or peak is None:
        return None
    names = [n for n in t.op_s if KERNEL in n]
    seconds = sum(t.op_s[n] for n in names)
    if not seconds:
        return None
    calls = sum(t.op_n[n] for n in names)
    least = peaks.least_seconds(run.cell.work().k4(run.cell.task), peak)
    return 100.0 * calls * least / seconds
