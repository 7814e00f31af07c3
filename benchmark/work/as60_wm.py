"""Least work of one WM step of the separable AS model as
`examples/as_model/semi_wm.json` runs it, per batch of n trajectories of
d modes at the precision's width (8 bytes a number at f64).

The HK part is `work/as60.py`'s step: the state q, p, the four diagonal
monodromy planes, S and the prefactor's sign tracker read and written
once, and the Morse RK4 with its monodromy (WM keeps the HK prefactor C).
It counts no error-bar moments.

The separable WM chain adds, at the port's structure:

* K5 (`ops.wm_diag`, `csrc/wm_diag.cu`) once: its ten (n, d) input planes
  read (Mqq, Mqp, Mpq, Mpp, dQ, dp, dq, n1q, n1Q, v0c), its (n, 30) sums
  and (4, n, d) per-mode det planes written, its (17, d) constant pack
  read; ~290 operations a trajectory and mode, counted from
  `csrc/wm_diag.cu` as the kernel checks count them (`K5_FLOPS`);
* the detA and detM sign trackers: each its previous complex value and its
  sign, read and written (3 n numbers each);
* the two log-space mode products over K5's det planes: for each mode two
  squares, a sum, a log, an angle and the two mode sums (7 operations).

The monodromy planes K5 reads again are counted again: K5 reads them in a
launch of its own."""

from work import as60

K5_FLOPS = 290
K5_SUMS = 30
K5_CONSTS = 17
K5_PLANES = 14                    # ten read, four written
TRACKER_NUMBERS_PER_TRAJ = 6      # detA, detM: previous value (2), sign
LOGSPACE_OPS_PER_MODE = 2 * 7


def _width(task):
    return 8 if task.get("precision", "f64") == "f64" else 4


def _type(task):
    return "float64" if _width(task) == 8 else "float32"


def k5(task):
    """{"bytes", "flops": {type: operations}} of one K5 launch over the
    task's batch."""
    n, d = as60._dims(task)
    return {"bytes": _width(task) * (K5_PLANES * n * d + K5_SUMS * n
                                     + K5_CONSTS * d),
            "flops": {_type(task): K5_FLOPS * n * d}}


def step(task):
    """{"bytes", "flops": {type: operations}} of one step of the whole
    batch: `as60.step` plus K5, the trackers and the mode products."""
    n, d = as60._dims(task)
    hk, chain = as60.step(task), k5(task)
    trackers = 2 * _width(task) * TRACKER_NUMBERS_PER_TRAJ * n
    flops = dict(hk["flops"])
    for kind, ops in chain["flops"].items():
        flops[kind] = flops.get(kind, 0) + ops
    flops[_type(task)] = (flops.get(_type(task), 0)
                          + LOGSPACE_OPS_PER_MODE * n * d)
    return {"bytes": hk["bytes"] + chain["bytes"] + trackers,
            "flops": flops}
