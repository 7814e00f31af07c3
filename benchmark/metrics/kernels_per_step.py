"""Launches a step: the device kernels of the traced repetition (the
trace's launches by name), less the section clock's stamp kernels and
the copies and fills, over the repetition's steps. Each kernel of a
replayed graph is one node the graph launches, so this is what fusing
kernels and closing the graph's gaps move. Nothing where the window holds
no device operation (no card)."""

STAMP = "stamp_kernel"
NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    t = run.trace
    traced = [r for r in run.done if r["traced"]]
    if t is None or t.device_ops == 0 or not traced:
        return None
    kernels = sum(n for name, n in t.op_n.items()
                  if STAMP not in name and not name.startswith(NOT_KERNELS))
    return kernels / traced[0]["steps"]
