"""Sampling: the harness's span around the normals' draw, a new
propagator and `initial_conditions`, the card synchronised at its end;
mean per repetition of the window (in a traced run the traced
repetition, which follows the window, is left out), ms. Host clock."""


def read(run):
    vals = [r["sample_s"] for r in run.timed if "sample_s" in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
