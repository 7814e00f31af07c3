"""Graphs captured plus blocks run eagerly inside the window and the
traced repetition that follows it (`propagation.graph.STATS`, after
minus before): 0 when set-up warmed up every block length the window
replays."""


def read(run):
    if "captures" not in run.counters:
        return None
    return run.counters["captures"] + run.counters["eager_blocks"]
