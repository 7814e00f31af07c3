# coding: utf-8
"""Mid-batch checkpoint and resume of a propagator, the port of
`semiclassical_tpu.checkpoint`.

A checkpoint is one `.npz` holding what the time loop carries between
segments: the trajectory state (q, p, Z, S), the branch-cut sign trackers,
every field of the batch constants, the current time and the batch size,
and the partial C(t) / k~ic(t) accumulated so far. Keys are the
propagator's own layout (`state/Z`, `tracker/detA/signs`,
`bc/base/logw_norm`, ...); every tensor is stored at its own dtype, so a
checkpoint of a reduced-precision run (float32 / complex64 tensors, the
comp32 residuals `state/qc`, `state/pc` and the center's `params/q0c`,
`params/p0c`) resumes bit for bit, and one resumed under another
precision mode raises naming the first key that differs. The file is
written to `<name>.tmp.npz` and renamed over `<name>`, so a kill during a
write leaves the previous checkpoint intact.

Under a process group every rank writes its own file (the CLI names it
with `parallel.rank_path`) of its own rows, with its `meta/rank` and the
group's `meta/world`; a restore under another group size, or into another
rank, raises naming the key (the JAX package restores a mesh-sharded
checkpoint onto its mesh instead). `agree_on_resume` makes the ranks take
one decision about resuming.

The port's checkpoints are its own format: it neither reads the JAX
package's checkpoints nor writes theirs.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from semiclassical_tpu_torch.parallel.group import group_sum, world_of

logger = logging.getLogger(__name__)

__all__ = ["save_propagator_state", "load_propagator_state",
           "peek_checkpoint", "agree_on_resume", "CheckpointedRun"]


def _flatten(prefix, obj):
    """{key: value} of the tensor and float fields of a (nested) dataclass,
    keyed by the field path under `prefix`."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}/{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(_flatten(key, v))
        elif isinstance(v, (torch.Tensor, float)):
            out[key] = v
    return out


def _carried(propagator):
    return (("state", propagator.state), ("tracker", propagator.tracker),
            ("bc", propagator.bc))


def _hk_params(propagator):
    """The HK parameter pack (nested under `hk` in the WM pack)."""
    return getattr(propagator.params, "hk", propagator.params)


def _center_residuals(propagator):
    """{key: tensor} of the comp32 center residuals (empty otherwise)."""
    params = _hk_params(propagator)
    return {f"params/{name}": getattr(params, name)
            for name in ("q0c", "p0c") if getattr(params, name) is not None}


def _mode_mismatch(key, detail):
    return ValueError(
        f"checkpoint key '{key}' {detail}: it was written under another "
        "precision mode. Resume with the original --precision, or delete "
        "the checkpoint to restart the repetition.")


def save_propagator_state(filename, propagator, partial=None):
    """Snapshot a propagator's state, trackers, batch constants and time
    to `filename` (.npz). `partial` is an optional dict of what the run
    accumulated so far, e.g. {"cauto": ..., "kic": ..., "steps_done": n}."""
    payload = {}
    for prefix, obj in _carried(propagator):
        for key, v in _flatten(prefix, obj).items():
            payload[key] = (v.detach().cpu().numpy()
                            if isinstance(v, torch.Tensor) else np.asarray(v))
    for key, v in _center_residuals(propagator).items():
        payload[key] = v.detach().cpu().numpy()
    payload["meta/t"] = np.asarray(propagator.t)
    payload["meta/ntraj"] = np.asarray(propagator.ntraj)
    group = propagator.group
    payload["meta/rank"] = np.asarray(0 if group is None else group.rank)
    payload["meta/world"] = np.asarray(world_of(group))
    for k, v in (partial or {}).items():
        payload[f"partial/{k}"] = np.asarray(v)
    # np.savez appends .npz to a name without it: keep the extension explicit
    tmp = filename + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, filename)


def peek_checkpoint(filename):
    """The `partial` entries of a checkpoint, without a propagator (which
    repetition and step to resume)."""
    with np.load(filename) as data:
        return {key[len("partial/"):]: data[key] for key in data.files
                if key.startswith("partial/")}


def _restore(data, prefix, obj, device):
    """`obj` with every tensor and float field replaced by the
    checkpoint's, each tensor on `device`; a missing key, another shape or
    another dtype raises ValueError naming the key, as does a tensor the
    checkpoint holds for a field that is None here (a comp32 residual)."""
    fields = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}/{f.name}"
        if dataclasses.is_dataclass(v):
            fields[f.name] = _restore(data, key, v, device)
            continue
        if v is None and key in data:
            raise _mode_mismatch(key, "has no counterpart in this run")
        if not isinstance(v, (torch.Tensor, float)):
            continue
        if key not in data:
            raise ValueError(
                f"checkpoint is missing '{key}': it was written by a "
                "propagator of another kind or state representation. "
                "Resume with the original configuration, or delete the "
                "checkpoint to restart the repetition.")
        arr = data[key]
        if isinstance(v, float):
            fields[f.name] = float(arr)
            continue
        if tuple(arr.shape) != tuple(v.shape):
            raise ValueError(
                f"checkpoint shape mismatch for '{key}': {arr.shape} vs "
                f"{tuple(v.shape)} — the checkpoint was written with another "
                "monodromy representation or batch size. Resume with the "
                "original configuration, or delete the checkpoint to "
                "restart the repetition.")
        stored = torch.from_numpy(np.ascontiguousarray(arr))
        if stored.dtype != v.dtype:
            raise _mode_mismatch(key, f"holds {stored.dtype} where this run "
                                      f"has {v.dtype}")
        fields[f.name] = stored.to(device)
    return dataclasses.replace(obj, **fields)


def load_propagator_state(filename, propagator):
    """Restore a snapshot into an initialised propagator of the same kind
    and batch size (call `initial_conditions` first; the sampled values
    are overwritten). The exact maps are rebuilt from the restored state
    at the next step. Returns the `partial` dict stored at save time
    (possibly empty)."""
    with np.load(filename) as data:
        data = {key: data[key] for key in data.files}
    group = propagator.group
    for key, here in (("meta/world", world_of(group)),
                      ("meta/rank", 0 if group is None else group.rank)):
        stored = int(data.get(key, 0 if key == "meta/rank" else 1))
        if stored != here:
            raise ValueError(
                f"checkpoint key '{key}' holds {stored} where this run has "
                f"{here}: the checkpoint was written by another process "
                "group. Resume with the original --num-processes and "
                "--process-id, or delete the checkpoints to restart the "
                "repetition.")
    device = propagator.device
    residuals = _center_residuals(propagator)
    for key in ("params/q0c", "params/p0c"):
        if (key in data) != (key in residuals):
            raise _mode_mismatch(key, "is missing" if key in residuals
                                 else "has no counterpart in this run")
        if key in data and not np.array_equal(
                data[key], residuals[key].cpu().numpy()):
            raise ValueError(f"checkpoint key '{key}' holds another "
                             "wavepacket center: it belongs to another task")
    restored = {prefix: _restore(data, prefix, obj, device)
                for prefix, obj in _carried(propagator)}
    propagator.state = restored["state"]
    propagator.tracker = restored["tracker"]
    propagator.bc = restored["bc"]
    propagator.t = float(data["meta/t"])
    propagator._invalidate_map()
    return {key[len("partial/"):]: v for key, v in data.items()
            if key.startswith("partial/")}


def agree_on_resume(filename, group):
    """The `partial` entries of this process's checkpoint to resume from,
    or None to start afresh, decided alike on every rank of `group` (one
    all-reduce): the ranks resume when every rank holds a checkpoint of
    this group's size at one repetition and step; a checkpoint of another
    group size raises naming 'meta/world', and checkpoints on some ranks
    only, or at different steps, raise — resuming them would mix batches.
    A single process resumes whenever its file exists."""
    meta, found, other_world = None, 0, 0
    if filename and os.path.exists(filename):
        with np.load(filename) as data:
            other_world = int(int(data.get("meta/world", 1))
                              != world_of(group))
        meta = peek_checkpoint(filename)
        found = 1
    if group is None or not filename:
        return meta
    at = ((int(meta.get("repetition", 0)), int(meta.get("steps_done", 0)))
          if meta else (0, 0))
    # the spread of the ranks' (repetition, step) is zero iff they agree
    flags = torch.tensor([found, other_world, *at, *(x * x for x in at)],
                         dtype=torch.float64, device=group.device)
    found, other_world, rep, step, rep2, step2 = group_sum(
        [flags], group)[0].tolist()
    if other_world:
        raise ValueError(
            "checkpoint key 'meta/world' of a rank's checkpoint differs "
            f"from this group's size {group.world}: resume with the "
            "original --num-processes, or delete the checkpoints to restart "
            "the repetition")
    if not found:
        return None
    if (found != group.world or group.world * rep2 != rep * rep
            or group.world * step2 != step * step):
        raise ValueError(
            f"the checkpoints '{filename}' of the group's ranks do not "
            f"match: {int(found)} of {group.world} ranks hold one, at "
            "different repetitions or steps (a run killed between two "
            "ranks' writes); delete them to restart the repetition")
    return meta


class CheckpointedRun:
    """Propagate in segments with a checkpoint after each, resuming from
    the checkpoint when it belongs to this repetition.

    >>> run = CheckpointedRun("ckpt.npz", propagator, potential, dt=dt,
    ...                       nt=2000, energy0_es=en0, segment=500)
    >>> cauto, kic, err_c, err_k = run.run()

    `run()` returns the 4-tuple; the stderr arrays are None when
    `error_bars` is off, or when the resumed checkpoint was written
    without them. `chunk` is the scan segment of each `propagate` call;
    with `norm_every`, segments also end at its multiples, where
    `norm_callback(step)` is called (and at step 0 of a fresh run).
    `progress(steps_done, nt, C(t) at the last step)` is called after
    every segment.
    """

    def __init__(self, filename, propagator, potential, dt, nt,
                 energy0_es=0.0, segment=500, chunk=100, repetition=0,
                 progress=None, error_bars=False, norm_every=0,
                 norm_callback=None):
        self.filename = filename
        self.propagator = propagator
        self.potential = potential
        self.dt = dt
        self.nt = nt
        self.en0 = energy0_es
        self.segment = segment
        self.chunk = chunk
        # a checkpoint of another repetition of the CLI's batch loop holds
        # other initial conditions: it is not resumed into this one
        self.repetition = repetition
        self.progress = progress
        self.error_bars = error_bars
        self.norm_every = int(norm_every)
        self.norm_callback = norm_callback

    def run(self):
        nt = self.nt
        cauto = np.zeros(nt, dtype=complex)
        kic = np.zeros(nt, dtype=complex)
        error_bars = self.error_bars
        done = 0
        partial = {}
        if os.path.exists(self.filename):
            stored_rep = int(peek_checkpoint(self.filename)
                             .get("repetition", 0))
            if stored_rep == self.repetition:
                partial = load_propagator_state(self.filename,
                                                self.propagator)
                if partial:
                    done = int(partial["steps_done"])
                    cauto[:done] = partial["cauto"][:done]
                    kic[:done] = partial["kic"][:done]
                    if error_bars and "cauto_err" not in partial:
                        # the first `done` steps have no stderr, and zeros
                        # would be wrong values: drop the stderr keys for
                        # this repetition
                        logger.warning(
                            "resumed checkpoint '%s' was written without "
                            "error_bars — Monte-Carlo stderr is unavailable "
                            "for this repetition (restart it to get error "
                            "bars)", self.filename)
                        error_bars = False
        err_c = np.zeros(nt) if error_bars else None
        err_k = np.zeros(nt) if error_bars else None
        if error_bars and done:
            err_c[:done] = partial["cauto_err"][:done]
            err_k[:done] = partial["kic_err"][:done]
        while done < nt:
            seg = min(self.segment, nt - done)
            if self.norm_every > 0:
                if done % self.norm_every == 0 and \
                        self.norm_callback is not None:
                    self.norm_callback(done)
                # end the segment at the next monitoring boundary
                seg = min(seg, self.norm_every - done % self.norm_every)
            out = self.propagator.propagate(
                self.potential, self.dt, seg, energy0_es=self.en0,
                chunk=self.chunk, error_bars=error_bars)
            cauto[done:done + seg], kic[done:done + seg] = out[:2]
            if error_bars:
                err_c[done:done + seg], err_k[done:done + seg] = out[2:]
            done += seg
            partial = {"cauto": cauto, "kic": kic, "steps_done": done,
                       "repetition": self.repetition}
            if error_bars:
                partial["cauto_err"] = err_c
                partial["kic_err"] = err_k
            save_propagator_state(self.filename, self.propagator,
                                  partial=partial)
            if self.progress is not None:
                self.progress(done, nt, cauto[done - 1])
        return cauto, kic, err_c, err_k
