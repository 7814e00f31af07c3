"""K8's share of its roofline (`ops.observe`, `csrc/observe.cu`, the
separable step's observe): its least time, the bytes one launch must move
at float64 over the card's bandwidth, times its launches, over its device
time in the traced window, by kernel name. A launch in HK mode (the
instantiation `observe_kernel<HkStep, ...>`: the prefactor, its tracker,
C(t), k~ic(t) and their moments) reads six (n, d) planes (q, p and the
four diagonal monodromy planes) and 11 numbers a row (S, obs_re, obs_im,
the complex nacq; the tracker's complex C^2 and sign read and written);
one in WM mode (`observe_kernel<WmPrefactor, ...>`: the prefactor and its
tracker) reads the four planes and 8 numbers a row (the tracker read and
written, c written). n is the rows K8 runs on the traced card, the
task's batch or a rank's share of it in a group; d its model's modes.
Nothing where the window holds no K8 launch (a dense prefactor, a
reduced precision, or a port without K8) or the card is not in the peaks
table."""

from semibench import cell, peaks

KERNEL = "observe_kernel"
# (planes of n x d, numbers a row) of one launch, by mode
MODES = {"HkStep": (6, 11), "WmPrefactor": (4, 8)}
WIDTH = 8


def least_bytes(task, mode):
    """K8's bytes in one launch of `mode` over the task's whole batch."""
    n = int(task["batch_size"])
    d = int(task["potential"]["model"]["num_modes"])
    planes, numbers = MODES[mode]
    return (planes * n * d + numbers * n) * WIDTH


def read(run):
    t, peak = run.trace, peaks.of(run.device)
    if t is None or peak is None:
        return None
    names = [n for n in t.op_s if KERNEL in n]
    seconds = sum(t.op_s[n] for n in names)
    if not seconds:
        return None
    task = cell.rank_task(run.cell.task, run.world)
    least = 0.0
    for name in names:
        mode = next((m for m in MODES if m in name), None)
        if mode is None:
            return None
        least += t.op_n[name] * peaks.least_seconds(
            {"bytes": least_bytes(task, mode), "flops": {}}, peak)
    return 100.0 * least / seconds
