"""The check of `correct`: what the timed path produced against the plain
reference, number by number, each against its limit.

* `c_gap`, `k_gap`: the widest gap of C(t) and k~ic(t) of one repetition
  of the window, drawn from the seed, against the reference's run of the
  same normals, over the reference's largest modulus;
* `err_gap`: the same for the variances (the squared standard errors)
  of both curves, in cells with error bars: the standard error is the
  root of a difference that cancels, so its own gap swells where it is
  small, its square's does not;
* `npz_gap`: the results file against the trajectory-weighted merge of
  every repetition's curves, over the largest modulus;
* `c0_dev`: the largest |C(0) - 1| of a repetition (the task's own limit,
  1e-3);
* `failed`: repetitions that raised or gave NaN (limit 0).

The limits of the first four are the workload file's ("limits")."""

import numpy as np

from reference import common as ref_common
from reference import for_cell
from semibench import traffic

C0_LIMIT = 1.0e-3


def _gap(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want)))
    return float(np.max(np.abs(got - want))) / scale if scale else np.inf


def compared_repetition(run):
    """The index of the window's repetition the check recomputes: drawn
    from the seed among those that finished."""
    done = [r["index"] for r in run.done]
    rng = np.random.default_rng([int(run.seed) % 2 ** 64, 7])
    return int(rng.choice(done))


def numbers(run):
    """[(name, value, limit)] of the run; the reference runs on the run's
    device at float64."""
    import torch

    cell = run.cell
    limits = cell.workload["limits"]
    out = []
    failed = len(run.reps) - len(run.done)
    out.append(("failed", float(failed), 0.0))
    if not run.done:
        return out
    k = compared_repetition(run)
    normals = traffic.normals(cell.task, run.seed, traffic.WINDOW, k,
                              run.rank, run.device)
    ref = for_cell(cell).repetition(cell.task, run.table, normals,
                                    torch.float64)
    got = run.outputs[k]
    out.append(("c_gap", _gap(got["cauto"], ref["cauto"]), limits["c_gap"]))
    out.append(("k_gap", _gap(got["kic"], ref["kic"]), limits["k_gap"]))
    if "err_c" in ref:
        out.append(("err_gap", max(_gap(got[key] ** 2, ref[key] ** 2)
                                   for key in ("err_c", "err_k")),
                    limits["err_gap"]))
    merged = ref_common.merge([o for o in run.outputs if o is not None],
                              "err_c" in ref)
    npz = run.results
    gap = max(_gap(npz[key], merged[key]) for key in merged
              if key != "trajectories")
    if npz["trajectories"] != merged["trajectories"]:
        gap = np.inf
    out.append(("npz_gap", gap, limits["npz_gap"]))
    out.append(("c0_dev", float(max(abs(o["cauto"][0] - 1.0)
                                    for o in run.outputs if o is not None)),
                C0_LIMIT))
    return out


def correct(nums):
    return all(np.isfinite(v) and v <= lim for _, v, lim in nums)
