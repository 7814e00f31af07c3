# coding: utf-8
"""The port's tracing, phase timing and per-run metrics.

Tracing is on while a `torch.profiler` session records
(`torch.autograd.profiler._is_profiler_enabled`) or after `enable()` (the
CLI's `--trace`). Off, every call below costs one test and records
nothing, and the time loop's graphs are those of an untraced run.

* `span(name)` — a host range `semi.<name>` in the profiler's trace, and
  the range's host seconds and calls in the record. The range is a
  `cpu_op` on the trace's own clock (a `record_function` range would be a
  `user_annotation`, which the trace copies onto the card's timeline as
  if it were device work), so a device gap in the trace is named after
  the host work around it. `PhaseTimer.phase` opens one.
* `count(name)` and `to_host(x)` — program counters. Every blocking
  device-to-host read of a repetition goes through `to_host` and counts
  as `host_reads`: each drains the card's queue.
* `section(name)` — a mark in the time loop's step code: the work since
  the previous mark belongs to section `name` of `SECTIONS`. A mark does
  nothing unless the time loop traces the block it runs in (`sections`):
  on the card each mark is then a one-thread kernel that adds the
  device's global timer's advance since the previous mark to the
  section's slot (`SectionClock`, `csrc/stamp.cu`), captured in a twin of
  each block's graph (`propagation.graph`), so the sections come from the
  device with no host read per replay; on the CPU, whose operations are
  synchronous, a mark reads the host clock.
* `records()` — the newest tracing session's record: spans, counters,
  section seconds and the steps traced. A session's record starts at its
  first call with tracing on after a call that saw tracing off, or after
  `enable`.
* `PhaseTimer` — wall-clock accounting per phase (sample / scan / reduce)
  with a throughput summary in trajectory-steps per second. PyTorch returns
  before the card has finished, so a phase that closes on a CUDA device
  first waits for it (`torch.cuda.synchronize`): the time is the card's
  work, not its enqueueing.
* `RunMetrics` — structured per-batch diagnostics (energy drift, |C(t)|
  extrema, NaN flags) gathered once per batch on the host, never per step.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from semiclassical_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

__all__ = ["SECTIONS", "enable", "tracing", "span", "count", "to_host",
           "section", "sections", "SectionClock", "collect", "records",
           "ms_per_step", "trace_to", "PhaseTimer", "RunMetrics"]

# the time loop's sections, in the order of a step: the HK prefactor and
# its sign tracker (K4 / K1), on WM's separable path the assembly of K5's
# input planes, WM's scalar forms and the detA / detM trackers (K2 x3, or
# K5 and what follows it), the observables and their sums and moments, the
# taylor window's expansion (the PES Hessian and the window's monodromy
# map), the integrator's stages and the q, p, S update (or the exact map),
# the monodromy update, and the block-end copies
SECTIONS = ("prefactor", "wm_inputs", "wm_derived", "observables", "window",
            "integrator", "monodromy", "slots")
_SLOT = {name: i for i, name in enumerate(SECTIONS)}

_enabled = False
_record = None       # the newest tracing session's record
_stale = True        # a call saw tracing off since the record began
_mark = None         # the traced block's clock's mark, else None


def enable(on=True):
    """Trace without a profiler session (`on` False: only inside one); a
    session's record starts at the next call."""
    global _enabled, _stale
    _enabled = bool(on)
    _stale = True


def tracing():
    """True while a `torch.profiler` session records or after `enable()`."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def _live():
    """The tracing session's record, or None with tracing off."""
    global _record, _stale
    if not tracing():
        _stale = True
        return None
    if _stale:
        _record = {"spans": {}, "counters": {}, "sections": {}, "steps": 0}
        _stale = False
    return _record


class _Span:
    __slots__ = ("_name", "_spans", "_range", "_t0")

    def __init__(self, name, spans):
        self._name, self._spans = name, spans

    def __enter__(self):
        self._range = torch._C._profiler._RecordFunctionFast(
            "semi." + self._name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        entry = self._spans.setdefault(self._name, {"s": 0.0, "n": 0})
        entry["s"] += time.perf_counter() - self._t0
        entry["n"] += 1
        self._range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name):
    """A context manager: the host range `semi.<name>` and its seconds in
    the record while tracing is on, nothing otherwise."""
    record = _live()
    return _OFF if record is None else _Span(name, record["spans"])


def count(name, n=1):
    """Add `n` to the record's counter `name` while tracing is on."""
    record = _live()
    if record is not None:
        record["counters"][name] = record["counters"].get(name, 0) + n


def to_host(x):
    """`x.cpu()`, a blocking device-to-host read, counted as `host_reads`
    while tracing is on."""
    count("host_reads")
    return x.cpu()


def section(name):
    """Mark the end of the time loop's section `name` (`SECTIONS`) in a
    traced block; nothing elsewhere."""
    if _mark is not None:
        _mark(name)


@contextlib.contextmanager
def sections(clock):
    """Trace one block of the time loop on `clock` (a `SectionClock`): a
    stamp at its start, the marks of its step code, and a stamp after its
    body, which closes the block-end copies ("slots")."""
    global _mark
    clock.start()
    _mark = clock.mark
    try:
        yield
        clock.mark("slots")
    finally:
        _mark = None


class SectionClock:
    """Time by section of the traced blocks of one time loop, kept where
    the blocks run. On the card: a device buffer of int64 nanoseconds, a
    slot per section and one for the last stamp, which each stamp kernel
    (`csrc/stamp.cu`) advances; made, and the kernel loaded, outside any
    capture, by the loop that owns it. Elsewhere: the host clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._last = len(SECTIONS)
        if self.device.type == "cuda":
            self._slots = torch.zeros(self._last + 1, dtype=torch.int64,
                                      device=self.device)
            self.start()
        else:
            self._slots = [0] * (self._last + 1)

    def start(self):
        """Stamp the start of a block: the time since the last stamp
        belongs to no section."""
        self._stamp(-1)

    def mark(self, name):
        """Stamp the end of section `name`."""
        self._stamp(_SLOT[name])

    def _stamp(self, slot):
        if self.device.type != "cuda":
            now = time.perf_counter_ns()
            if slot >= 0:
                self._slots[slot] += now - self._slots[self._last]
            self._slots[self._last] = now
            return
        _build.launch("stamp", torch.int64, self.device,
                      self._slots.data_ptr(), slot, self._last)

    def take(self):
        """{section: seconds} since the last take (sections that ran), the
        slots set to zero: on the card one host read."""
        if self.device.type == "cuda":
            ns = self._slots.cpu().tolist()
            self._slots.zero_()
        else:
            ns = list(self._slots)
            self._slots = [0] * (self._last + 1)
        return {name: ns[i] / 1e9 for i, name in enumerate(SECTIONS)
                if ns[i]}


def collect(clock, steps):
    """Add the sections that `clock` (a `SectionClock`, or None) holds and
    `steps` steps to the record while tracing is on: once a traced
    `propagate`, after its reads."""
    record = _live()
    if record is None:
        return
    if clock is not None:
        for name, seconds in clock.take().items():
            record["sections"][name] = (record["sections"].get(name, 0.0)
                                        + seconds)
    record["steps"] += int(steps)


def records():
    """A copy of the newest tracing session's record, or None before the
    first: "spans" {name: {"s": host seconds, "n": calls}}, "counters"
    {name: n}, "sections" {name: seconds}, "steps" (the time loop's steps
    whose sections it holds, of the whole batch)."""
    return None if _record is None else copy.deepcopy(_record)


def ms_per_step(record):
    """{section: ms a step} of a record."""
    steps = record["steps"]
    return ({name: 1e3 * s / steps for name, s in record["sections"].items()}
            if steps else {})


@contextlib.contextmanager
def trace_to(path, device):
    """Trace the body under `torch.profiler` (the CPU, and the card for a
    CUDA `device`) and write the session's Chrome trace to `path`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    enable()
    try:
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(str(path))
        logger.info(f"  trace written to {path}")
    finally:
        enable(False)


class PhaseTimer:
    """Accumulates wall-clock per phase; computes the throughput metric."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.phases[name] = self.phases.get(name, 0.0) + (
                    time.perf_counter() - t0)

    def throughput(self, traj_steps, phase="scan", nchips=1):
        """trajectory-steps per second of wall time in the given phase, per
        device of a group of `nchips`."""
        wall = self.phases.get(phase, 0.0)
        if wall <= 0:
            return float("nan")
        return traj_steps / wall / nchips

    def log(self, traj_steps=None, nchips=1):
        """The phases' walls and the throughput of `traj_steps` (of the
        whole group: per device over `nchips` devices); while tracing, the
        time loop's ms a step by section and the host reads."""
        for name, wall in sorted(self.phases.items()):
            logger.info(f"  phase {name:10s}: {wall:9.3f} s")
        if traj_steps:
            rate = self.throughput(traj_steps, nchips=nchips)
            where = (f"on {self.device}" if nchips == 1
                     else f"per device, {nchips} devices")
            logger.info(f"  throughput: {rate:,.0f} traj-steps/s {where}")
        record = records() if tracing() else None
        if record is not None:
            for name, ms in ms_per_step(record).items():
                logger.info(f"  section {name:11s}: {ms:9.4f} ms a step")
            logger.info(f"  host reads: "
                        f"{record['counters'].get('host_reads', 0)} "
                        f"({record['steps']} steps traced)")


@dataclass
class RunMetrics:
    """Structured per-batch physics diagnostics."""

    energy_drift_max: float = float("nan")
    c0_deviation: float = float("nan")
    abs_c_max: float = float("nan")
    abs_kic_max: float = float("nan")
    nan_detected: bool = False

    @staticmethod
    def from_run(energies, cauto, kic):
        energies = np.asarray(energies)
        cauto = np.asarray(cauto)
        kic = np.asarray(kic)
        drift = np.abs(np.diff(energies)).max() if energies.size > 1 else 0.0
        return RunMetrics(
            energy_drift_max=float(drift),
            c0_deviation=float(abs(cauto[0] - 1.0)),
            abs_c_max=float(np.abs(cauto).max()),
            abs_kic_max=float(np.abs(kic).max()),
            nan_detected=bool(np.isnan(cauto).any() or np.isnan(kic).any()
                              or np.isnan(energies).any()),
        )

    def to_json(self):
        return json.dumps(self.__dict__.copy())

    def log(self):
        logger.info(f"  metrics: {self.to_json()}")
