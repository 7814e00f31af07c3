"""The device's idle share of the traced window: 100 x (1 - the union of
the intervals in which an operation ran on the card / the window's
wall), both from the same `torch.profiler` trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.device_ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
