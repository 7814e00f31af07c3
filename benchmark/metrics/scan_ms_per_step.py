"""The time loop: the harness's span around `propagate` (every scan
segment, its host reads and the energy guard), synchronised, less the
norms inside it (the `norm` spans of a cell that takes norms, which
`norm_ms` reads), over the steps it ran; ms a step. Host clock."""


def read(run):
    done = [r for r in run.timed if "scan_s" in r]
    steps = sum(r["steps"] for r in done)
    seconds = sum(r["scan_s"] - r.get("norm_s", 0.0) for r in done)
    return 1e3 * seconds / steps if steps else None
