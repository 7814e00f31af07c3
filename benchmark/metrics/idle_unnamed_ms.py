"""The traced window's idle time that no host range names: ms of the
device's idle gaps (the trace's `idle_s`) whose label ends in ": no host
op", the host running code that neither makes an aten call nor sits in a
`semi.` span of the port. Nothing where no operation ran on a device."""

UNNAMED = ": no host op"


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0:
        return None
    return 1e3 * sum(s for label, s in t.idle_s.items()
                     if label.endswith(UNNAMED))
