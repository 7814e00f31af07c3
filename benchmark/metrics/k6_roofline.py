"""K6's share of its roofline (`ops.diag_mono`, `csrc/diag_mono.cu`, the
diagonal monodromy's RK4 step): its least time, 12 (n, d) planes at Z's
width over the card's bandwidth (Mqq, Mqp, Mpq, Mpp and the four stage
Hessian diagonals read, the four new planes written; n the rows K6 steps
on the traced card, the task's batch or a rank's share of it in a group,
d its model's modes, Z float64 under the precision "f64" and float32
under the others), times its launches, over its device time in the
traced window, by kernel name. Nothing where the window holds no K6
launch (a dense monodromy, or a port without K6) or the card is not in
the peaks table."""

from semibench import cell, peaks

KERNEL = "diag_mono_kernel"
PLANES = 12


def least_bytes(task):
    """K6's bytes in one launch over the task's whole batch."""
    n = int(task["batch_size"])
    d = int(task["potential"]["model"]["num_modes"])
    width = 8 if task.get("precision", "f64") == "f64" else 4
    return PLANES * n * d * width


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
    least = peaks.least_seconds({"bytes": least_bytes(task),
                                 "flops": {}}, peak)
    return 100.0 * calls * least / seconds
