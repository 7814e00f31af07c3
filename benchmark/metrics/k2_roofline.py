"""K2's share of its roofline (`ops.gj`, `csrc/gj_det.cu`, the block
kernel in its solve mode): the summed least times of the three shapes a
WM step launches (`work/<config>.py` `k2`: (n, 45, 45 | 90), (| 45),
(| 5)) times its launches over three, over its summed device time in the
traced window, by kernel name. Nothing where the window holds no K2
launch or the card is not in the peaks table."""

from semibench import peaks

KERNEL, SOLVE = "gj_block_kernel", "false"


def read(run):
    t, peak = run.trace, peaks.of(run.device)
    if t is None or peak is None:
        return None
    names = [n for n in t.op_s if KERNEL in n and SOLVE in n]
    seconds = sum(t.op_s[n] for n in names)
    if not seconds:
        return None
    steps = sum(t.op_n[n] for n in names) / 3
    least = sum(peaks.least_seconds(w, peak)
                for w in run.cell.work().k2(run.cell.task))
    return 100.0 * steps * least / seconds
