"""The time loop: the harness's span around `propagate` (every scan
segment, its host reads and the energy guard), synchronised, over the
steps it ran; ms a step. Host clock."""


def read(run):
    done = [r for r in run.timed if "scan_s" in r]
    steps = sum(r["steps"] for r in done)
    return 1e3 * sum(r["scan_s"] for r in done) / steps if steps else None
