"""Reduction: the harness's span around `io.results.accumulate_results`
(the observables already on the host), synchronised; mean per
repetition of the window (in a traced run the traced repetition, which
follows the window, is left out), ms. Host clock."""


def read(run):
    vals = [r["reduce_s"] for r in run.timed if "reduce_s" in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
