"""K1's share of its roofline (`ops.det`, `csrc/det_lu.cu`): its least
time at the cell's (n, 6, 6) complex128 shape (`work/<config>.py` `k1`,
bytes and LU operations; n the rows of the traced card) times its
launches, over its device time in the traced window, by kernel name: the
rows kernel and the warp kernel, not K4's block kernel. Nothing where the
window holds no K1 launch or the card is not in the peaks table."""

from semibench import cell, peaks

KERNELS = ("det_lu_rows_kernel", "det_lu_kernel")


def read(run):
    t, peak = run.trace, peaks.of(run.device)
    if t is None or peak is None:
        return None
    names = [n for n in t.op_s if any(k in n for k in KERNELS)]
    seconds = sum(t.op_s[n] for n in names)
    if not seconds:
        return None
    calls = sum(t.op_n[n] for n in names)
    task = cell.rank_task(run.cell.task, run.world)
    least = peaks.least_seconds(run.cell.work().k1(task), peak)
    return 100.0 * calls * least / seconds
