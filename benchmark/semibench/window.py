"""One run of a cell: set-up, the measured window of repetitions, and the
records the metric readers and the check of `correct` read.

Set-up builds the potential once and warms up each block length of the
time loop that the window replays (its eager run and its capture), on a
warm-up repetition of the cell's batch size, and nothing more. The window
then runs whole repetitions, one after another, as long as each begins
before `seconds` have passed; every end-to-end metric covers all of it.
With `trace`, one more repetition runs under `torch.profiler` once the
window has closed (the traced window), and the trace is reduced after
it: the window's repetitions, which the span metrics read, run as in an
untraced run."""

import contextlib
import dataclasses
import tempfile
import time

from semibench import models, trace as tracing, traffic
from semibench.program import Program, block_lengths


@dataclasses.dataclass
class Run:
    cell: object
    seed: int
    device: object
    setup_s: float = 0.0
    window_s: float = 0.0
    reps: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    results: dict = None
    table: object = None
    rank: int = 0

    @property
    def done(self):
        """The repetitions that finished."""
        return [r for r in self.reps if not r["failed"]]

    @property
    def timed(self):
        """The window's repetitions that finished, the traced one left
        out: what the span metrics read."""
        return [r for r in self.done if not r["traced"]]

    @property
    def traj_steps(self):
        return sum(r["ntraj"] * r["steps"] for r in self.timed)


class Spans:
    """The harness's own spans around the calls into each layer: host
    clock, the card synchronised at each span's end (the arithmetic of the
    port's `profiling.PhaseTimer`), and a `record_function` range of the
    same name for the traced window."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device

    @contextlib.contextmanager
    def __call__(self, record, name):
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(f"bench.{name}"):
            try:
                yield
            finally:
                if self.device.type == "cuda":
                    self.torch.cuda.synchronize(self.device)
                record[f"{name}_s"] = (record.get(f"{name}_s", 0.0)
                                       + time.perf_counter() - t0)


def _delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


def execute(cell, seed, seconds, trace, device, t0, system=None,
            max_reps=None):
    """Set up, warm up and run the window of `cell`; returns the Run.
    `t0` is the process's start on the host clock; `system` replaces the
    port (the control, the tests' faults); `max_reps` ends the window
    after that many repetitions (the calibration's single ones). The
    model file and the results file live in a directory under TMPDIR
    that is removed on return."""
    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        return _execute(cell, seed, seconds, trace, device, t0, system,
                        max_reps, workdir)


def _execute(cell, seed, seconds, trace, device, t0, system, max_reps,
             workdir):
    import torch

    device = torch.device(device)
    run = Run(cell=cell, seed=seed, device=device)
    task = cell.task
    potential = models.resolve(task["potential"], workdir)
    run.table = models.table(potential.get("model_file"))
    make = system or Program
    prog = make(task, potential, f"{workdir}/correlations.npz", device)
    run.rank = prog.rank
    spans = Spans(device)

    # warm-up: each block length of the window twice (eager, then the
    # capture), on a repetition of the cell's batch size
    prog.sample(traffic.normals(task, seed, traffic.WARMUP, 0, run.rank,
                                device))
    for length in block_lengths(prog) if system is None else []:
        prog.scan(nt=length)
        prog.scan(nt=length)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = prog.counters()
    run.setup_s = time.perf_counter() - t0

    start = time.perf_counter()
    while (time.perf_counter() - start < seconds
           and (max_reps is None or len(run.reps) < max_reps)):
        _repetition(run, prog, spans, task)
    run.window_s = time.perf_counter() - start
    if trace:
        prof = _repetition(run, prog, spans, task, traced=True)
        if prof is not None:
            run.trace = tracing.summarize(prof)
    if device.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.counters = _delta(prog.counters(), before)
    run.results = prog.results()
    prog.release()
    return run


def _repetition(run, prog, spans, task, traced=False):
    """One repetition of the task, sampled, scanned and reduced under the
    harness's spans, recorded in `run`; `traced` runs it under
    `torch.profiler` and returns the profile."""
    import torch

    index = len(run.reps)
    rec = {"index": index, "ntraj": int(task["batch_size"]),
           "steps": int(task["num_steps"]), "failed": False,
           "traced": traced}
    profiler = tracing.profiler() if traced else contextlib.nullcontext()
    prof = None
    try:
        with profiler as prof:
            with torch.profiler.record_function("bench.traced"):
                with spans(rec, "sample"):
                    prog.sample(traffic.normals(task, run.seed,
                                                traffic.WINDOW, index,
                                                run.rank, run.device))
                with spans(rec, "scan"):
                    out = prog.scan()
                with spans(rec, "reduce"):
                    prog.reduce(out)
        run.outputs.append(out)
    except RuntimeError as exc:
        rec["failed"] = True
        rec["error"] = str(exc)
        run.outputs.append(None)
    run.reps.append(rec)
    return prof
