# coding: utf-8
"""The compiled time loop: each scan segment as replays of CUDA graphs.

The counterpart of the JAX package's `_hk_scan_jit` / `_wm_scan_jit` /
`_hk_scan_micro_jit`, which make a scan segment (and every sub-batch of a
micro-batched one) ONE dispatch. The port keeps the step code eager and
records it instead: a *block* of B steps (the observables, the sign
trackers, the RK4 step or the exact map, and the kernels K1, K2, K4 and K5
they launch) is captured once as a `torch.cuda.CUDAGraph` and replayed for
every later block of the same length, so the host issues one replay where
the eager loop issued every launch of every step.

* **One loop per device, held by the process.** The counterpart of the
  JAX package's jit cache: the live `SegmentGraph` of each device sits in
  this module (`live`), keyed by value on everything a block bakes in (the
  propagator's class, integrator and precision, dt, the error-bar mode,
  the sub-batch layout, the host scalars of the parameter pack and the
  shapes, dtypes and structure of every tensor a block reads) and by
  identity on the potential, the one object that lives the whole run. A
  new batch, a new propagator, a new draw or a restored checkpoint of the
  same key runs through the kept loop and its graphs; another key drops
  the live loop before the new one is built (`segment_graph`), so the old
  graphs never sit beside the new ones. `clear` drops it by hand.
* **Static buffers.** Everything a block reads lives in buffers allocated
  once (`SegmentGraph.static`): the state, the trackers and the
  integrator's carry, which the block advances and copies back, and the
  per-batch inputs (the parameter pack, the batch constants, the exact
  Morse map's pack), which the owner loads before each run. A block
  writes each step's observables into static slots of its own, which the
  caller copies into their columns after the block. Sub-batches of
  `micro_batch` run one after another through the same buffers, of one
  sub-batch's rows, so they share the graphs, as `lax.map` shares one
  compiled body.
* **Warm-up.** The first block of each length runs eagerly as real
  work; the second captures that block and replays it. A capture
  never runs the work itself, so the eager block computes every value
  that the step code caches lazily (casts kept in a potential, the
  kernel library's build) before any capture reads it.
* **Memory and stream.** Every graph of the process on a device
  allocates from one private pool (`torch.cuda.graph(pool=...)`) and is
  captured on one side stream, where its warm-up block ran; the graphs
  replay on the current stream, one after another, so they share one
  step's temporaries.
* **Capture mode.** Captures run in CUDA's "relaxed" mode: cuBLAS may
  pick, for the addresses a capture allocates, a kernel whose module the
  eager block did not need, and loading it (CUDA loads modules lazily) is
  a call the default mode refuses inside a capture. On the H100 a long
  process met that at a WM methylium capture, in cuBLAS; it passed in
  relaxed mode and with eager module loading. A read of the host still
  fails a capture (it synchronises the capturing stream), and the CPU
  tests hold every block body free of them.
* **Launch counts.** The kernel wrappers count launches on the host
  (`ops.*.LAUNCHES`, `LAUNCHES_BY_DTYPE`), which a replay does not run. A
  capture records each counter's change, takes it back (the capture ran
  nothing), and every replay adds it.
* **Eager.** On a CPU tensor, and on the card inside `eager()` (the
  counterpart of `jax.disable_jit`), every block runs eagerly through the
  same body; a kept loop's graphs stay for the calls after. Nothing falls
  back: a failed capture or replay raises.
* **Twin graphs: the device time by section.** Python inside a block runs
  only at its capture, so a replay can time nothing on the host. Right
  after each block's graph the loop captures a twin of it, in the same
  pool and on the same stream, with the step code's section marks on
  (`profiling.section`): each mark a stamp kernel that adds the device's
  time since the previous stamp to its section's slot in the loop's
  `profiling.SectionClock`. A replay runs the twin in place of the graph
  while tracing is on (`profiling.tracing`), and an eager block runs with
  the marks on; the clock is read once a traced `propagate`, after its
  reads. Untraced, the marks do nothing and the graphs replayed are
  those an untraced capture makes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch

from semiclassical_tpu_torch import profiling

__all__ = ["BLOCK_STEPS", "STATS", "SegmentGraph", "eager", "captures",
           "block_lengths", "segment_graph", "live", "clear",
           "read_launches", "add_launches", "clone_tree", "copy_tree",
           "signature"]

# The block length B away from a taylor_every window. Measured on an H100
# at the most host-bound path, HK methylium at 10,000 trajectories
# (`scripts/torch_step_profile.py --blocks`, PERF.md): B = 5, 10, 20 and 40
# replay at 0.54, 0.53-0.54, 0.54 and 0.56 ms a step, and capture plus
# instantiate in 0.03, 0.04, 0.12 and 0.23 s; 10 is as fast as any and
# cheap to capture, and divides the CLI's default segments of 100 and 500
# steps, so those segments have no tail.
BLOCK_STEPS = 10

# What the loops of this process did, for measurements (host counters,
# like the kernels' LAUNCHES): blocks run eagerly (warm-ups, the CPU,
# `eager()`), graphs captured, their capture plus instantiate seconds
# (host clock), replays (of a graph or its twin), and the twins captured
# with their seconds.
STATS = {"eager_blocks": 0, "captures": 0, "capture_s": 0.0, "replays": 0,
         "trace_captures": 0, "trace_capture_s": 0.0}

_EAGER_DEPTH = 0
_SIDE = {}      # device index -> (capture stream, graph memory pool)
_LOOPS = {}     # device ("cpu" or a CUDA index) -> its live SegmentGraph

_COUNTER_MODULES = ("semiclassical_tpu_torch.ops.det",
                    "semiclassical_tpu_torch.ops.det_block",
                    "semiclassical_tpu_torch.ops.gj",
                    "semiclassical_tpu_torch.ops.wm_diag",
                    "semiclassical_tpu_torch.ops.diag_mono",
                    "semiclassical_tpu_torch.ops.morse_rk4")
_COUNTERS = ("LAUNCHES", "LAUNCHES_BY_DTYPE")


@contextlib.contextmanager
def eager():
    """Run the time loop's blocks eagerly on the card: every launch of
    every step from the host, as PyTorch runs by default (the counterpart
    of `jax.disable_jit`). For tests, comparisons and profiles."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


def captures(device) -> bool:
    """True where the loop captures its blocks: a CUDA device, outside
    `eager()`."""
    return torch.device(device).type == "cuda" and _EAGER_DEPTH == 0


def block_lengths(steps, window=1):
    """The block lengths of a segment of `steps` steps: blocks of B =
    BLOCK_STEPS (under a taylor_every `window`, the least multiple of it
    not below BLOCK_STEPS, so every block starts at a window head and spans
    whole windows), then the remainder as a block of its own length."""
    block = window * -(-BLOCK_STEPS // window)
    return [block] * (steps // block) + ([steps % block] if steps % block
                                         else [])


# ---------------------------------------------------------------------------
# the kernels' launch counters
# ---------------------------------------------------------------------------

def _flatten(out, key, value):
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(out, (*key, k), v)
    else:
        out[key] = value


def read_launches():
    """Every launch counter of the kernel wrappers as {(module, counter,
    *keys): count}: `LAUNCHES` and `LAUNCHES_BY_DTYPE` of `ops.det`,
    `ops.det_block`, `ops.gj`, `ops.wm_diag`, `ops.diag_mono` and
    `ops.morse_rk4` (those imported)."""
    out = {}
    for name in _COUNTER_MODULES:
        module = sys.modules.get(name)
        if module is not None:
            for counter in _COUNTERS:
                _flatten(out, (name, counter), getattr(module, counter))
    return out


def add_launches(delta, sign=1):
    """Add `sign` times the counts of `delta` (a `read_launches`
    difference) to the counters, in place."""
    for (name, counter, *keys), n in delta.items():
        module = sys.modules[name]
        if not keys:
            setattr(module, counter, getattr(module, counter) + sign * n)
            continue
        table = getattr(module, counter)
        for k in keys[:-1]:
            table = table[k]
        table[keys[-1]] += sign * n


def _launch_delta(before, after):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


# ---------------------------------------------------------------------------
# trees of tensors (TrajState, trackers, carries)
# ---------------------------------------------------------------------------

def _map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(_map(fn, x) for x in obj)
    return obj


def _leaves(obj, out=None):
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out)
    elif isinstance(obj, tuple):
        for x in obj:
            _leaves(x, out)
    return out


def clone_tree(obj):
    """A copy of every tensor of a tree of dataclasses and tuples (other
    leaves kept)."""
    return _map(torch.clone, obj)


def copy_tree(dst, src):
    """Copy the tensors of `src` into those of `dst`, a tree of the same
    structure (a tensor copied onto itself is left alone)."""
    dst, src = _leaves(dst), _leaves(src)
    if len(dst) != len(src):
        raise ValueError(f"copy_tree: {len(src)} tensors into {len(dst)}")
    for d, s in zip(dst, src):
        if d is not s:
            d.copy_(s)


def signature(obj):
    """The structure of a tree as a hashable value: the shape and dtype of
    each tensor, None for an absent field, and every other leaf (a host
    scalar that the step code bakes into a graph) by value."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, *(signature(getattr(obj, f.name))
                                      for f in dataclasses.fields(obj)))
    if isinstance(obj, tuple):
        return tuple(signature(x) for x in obj)
    return obj


# ---------------------------------------------------------------------------
# the graphs of one time loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Block:
    body: object          # () -> None: the steps, on the static buffers
    slots: object         # the block's static observable slots
    warm: bool = False    # the eager warm-up ran
    graph: object = None  # the captured graph
    twin: object = None   # the graph with the section marks on
    launches: dict = dataclasses.field(default_factory=dict)


class SegmentGraph:
    """The blocks of a time loop under one context `key` (see
    `segment_graph`), over the static buffers `static`.

    `run(name, make)` runs the block `name` (its length): `make()` gives
    (body, slots) the first time, `body()` the steps on the static
    buffers and `slots` the tensors it writes its observables into; the
    first call runs it eagerly, the second captures it and its twin and
    replays one of them, later ones replay one: the twin while tracing
    is on, the graph otherwise. Where `captures(device)` is false at the
    call (a CPU device, or inside `eager()`) the call runs the body and
    leaves the block's graphs for later calls; `capture` True or False
    fixes the choice instead. A block run eagerly while tracing is on
    runs with the section marks on. `sections` is the loop's
    `profiling.SectionClock`, made at its first traced block or twin."""

    def __init__(self, key, static, device, capture=None):
        self.key = key
        self.static = static
        self.device = torch.device(device)
        self.capture = capture
        self.stream, self.pool = (_side(self.device)
                                  if self.device.type == "cuda"
                                  else (None, None))
        self.blocks = {}
        self.stepper = None   # the owner's step functions the blocks call
        self.sections = None

    def matches(self, key):
        """True when `key` names this loop's context: objects compared by
        identity, values by equality."""
        return len(key) == len(self.key) and all(
            a is b or (not _is_object(a) and a == b)
            for a, b in zip(key, self.key))

    def run(self, name, make):
        block = self.blocks.get(name)
        if block is None:
            block = self.blocks[name] = _Block(*make())
        traced = profiling.tracing()
        if not (captures(self.device) if self.capture is None
                else self.capture):
            (self._traced(block.body) if traced else block.body)()
            STATS["eager_blocks"] += 1
        elif not block.warm:
            self._warm_up(block, traced)
        else:
            if block.graph is None:
                self._capture(block)
            self._replay(block, traced)
        return block.slots

    def _traced(self, body):
        """`body` with the section marks on, on the loop's clock (made
        here, outside any capture, at the first call)."""
        if self.sections is None:
            self.sections = profiling.SectionClock(self.device)
        clock = self.sections

        def traced():
            with profiling.sections(clock):
                body()

        return traced

    @contextlib.contextmanager
    def _on_stream(self):
        if self.stream is None:
            yield
            return
        current = torch.cuda.current_stream()
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            yield
        current.wait_stream(self.stream)

    def _warm_up(self, block, traced):
        body = self._traced(block.body) if traced else block.body
        with self._on_stream():
            body()
        block.warm = True
        STATS["eager_blocks"] += 1

    def _capture(self, block):
        block.graph, block.launches, seconds = self._counted(block.body)
        STATS["capture_s"] += seconds
        STATS["captures"] += 1
        block.twin, _, seconds = self._counted(self._traced(block.body))
        STATS["trace_capture_s"] += seconds
        STATS["trace_captures"] += 1

    def _counted(self, body):
        """(the graph of `body`, the launch counts its capture recorded,
        the capture's seconds)."""
        before = read_launches()
        t0 = time.perf_counter()
        try:
            graph = self._record(body)
        finally:
            # the capture launched nothing: its counts return with each
            # replay (and not at all when it failed)
            launches = _launch_delta(before, read_launches())
            add_launches(launches, -1)
        return graph, launches, time.perf_counter() - t0

    def _record(self, body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="relaxed"):
            body()
        return graph

    def _replay(self, block, traced):
        (block.twin if traced else block.graph).replay()
        add_launches(block.launches)
        STATS["replays"] += 1


def _device_key(device):
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.current_device() if device.index is None else device.index


def segment_graph(key, device, build):
    """(the time loop of `device` for the context `key`, True if it is
    new). The device's live loop serves while its key matches `key`
    (objects compared by identity, values by equality), whatever
    propagator, batch or sub-batch calls it; otherwise the live loop is
    dropped, and with it its graphs and buffers, before `build()` gives
    the new loop's (static buffers, stepper), and the new loop becomes
    the device's live one."""
    index = _device_key(device)
    loop = _LOOPS.get(index)
    if loop is not None and loop.matches(key):
        return loop, False
    loop = _LOOPS.pop(index, None)
    del loop                       # the old graphs go before the new ones
    static, stepper = build()
    loop = _LOOPS[index] = SegmentGraph(key, static, device)
    loop.stepper = stepper
    return loop, True


def live(device):
    """The live time loop of `device`, or None."""
    return _LOOPS.get(_device_key(device))


def clear(device=None):
    """Drop the live time loop of `device` (of every device when None):
    its graphs, its static buffers and the potential its key holds. For
    tests, and for a caller that wants the memory back between runs."""
    if device is None:
        _LOOPS.clear()
    else:
        _LOOPS.pop(_device_key(device), None)


def _side(device):
    """The capture stream and the graph memory pool of a CUDA device, one
    of each per process."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SIDE:
        _SIDE[index] = (torch.cuda.Stream(index),
                        torch.cuda.graph_pool_handle())
    return _SIDE[index]


def _is_object(x):
    return not isinstance(x, (int, float, str, bool, tuple, type(None),
                              torch.dtype))
