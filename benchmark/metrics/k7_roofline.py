"""K7's share of its roofline (`ops.morse_rk4`, `csrc/morse_rk4.cu`, the
RK4 trajectory step of a separable Morse PES): its least time, 8 (n, d)
planes and 3 n numbers at the state's width over the card's bandwidth (q
and p read, the new q and p and the four stage Hessian diagonals written;
S read, the new S and e1 written; n the rows K7 steps on the traced card,
the task's batch or a rank's share of it in a group, d its model's modes,
float64 under the precision "f64" and float32 under the others), times
its launches, over its device time in the traced window, by kernel name.
Nothing where the window holds no K7 launch (a PES other than a
non-harmonic Morse model at "stage", or a port without K7) or the card is
not in the peaks table."""

from semibench import cell, peaks

KERNEL = "morse_rk4_kernel"
PLANES = 8
ROW_NUMBERS = 3


def least_bytes(task):
    """K7's bytes in one launch over the task's whole batch."""
    n = int(task["batch_size"])
    d = int(task["potential"]["model"]["num_modes"])
    width = 8 if task.get("precision", "f64") == "f64" else 4
    return (PLANES * n * d + ROW_NUMBERS * n) * width


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
