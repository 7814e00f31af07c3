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
untraced run.

Under a process group (`group`, a `parallel.Group`; `semibench.group`
starts the ranks) every rank runs this same code: the same set-up and
warm-up, then every repetition, since the port's collectives need every
rank. Rank 0 alone decides whether another repetition begins and
broadcasts the decision (the harness's own `torch.distributed` call, not
the port's `group_sum`); rank 0 alone keeps the results file and the
breakdown; the peak is the largest of the ranks', the traced window's
busy time and length the means of theirs."""

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
    world: int = 1
    rank_busy_s: list = None
    rank_window_s: list = None
    # the forbidden modules (`guard`) the group's other ranks held as
    # their windows closed
    found_on_ranks: list = dataclasses.field(default_factory=list)
    # [(step, port, reference)] of the compared repetition's norms, set by
    # the check
    norm_readings: list = None

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
    same name for the traced window. Each adds its seconds to the record's
    `<name>_s` and one to its `<name>_n`."""

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
                record[f"{name}_n"] = record.get(f"{name}_n", 0) + 1


def _delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


def execute(cell, seed, seconds, trace, device, t0, system=None,
            max_reps=None, group=None, on_setup=None):
    """Set up, warm up and run the window of `cell`; returns the Run.
    `t0` is the process's start on the host clock; `system` replaces the
    port (the control, the tests' faults); `max_reps` ends the window
    after that many repetitions (the calibration's single ones); `group`
    is this rank's process group (None: a single process); `on_setup()`
    is called when set-up has ended. The model file and the results file
    live in a directory under TMPDIR that is removed on return."""
    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        return _execute(cell, seed, seconds, trace, device, t0, system,
                        max_reps, workdir, group, on_setup)


def _execute(cell, seed, seconds, trace, device, t0, system, max_reps,
             workdir, group, on_setup):
    import torch

    device = torch.device(device)
    run = Run(cell=cell, seed=seed, device=device,
              world=1 if group is None else group.world)
    leader = group is None or group.rank == 0
    task = cell.task
    potential = models.resolve(task["potential"], workdir)
    run.table = models.table(potential.get("model_file"))
    make = system or Program
    prog = make(task, potential, f"{workdir}/correlations.npz", device,
                group)
    run.rank = prog.rank
    spans = Spans(device)

    # warm-up: each block length of the window twice (eager, then the
    # capture), on a repetition of the cell's batch size, and one norm
    # where the task takes norms
    prog.sample(traffic.normals(task, seed, traffic.WARMUP, 0, run.rank,
                                device))
    for length in block_lengths(prog) if system is None else []:
        prog.scan(nt=length)
        prog.scan(nt=length)
    if system is None and prog.norm_every:
        prog.norm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    agree(group, True, device)       # every rank has warmed up
    before = prog.counters()
    run.setup_s = time.perf_counter() - t0
    if on_setup is not None:
        on_setup()

    start = time.perf_counter()
    while agree(group, time.perf_counter() - start < seconds
                 and (max_reps is None or len(run.reps) < max_reps),
                 device):
        _repetition(run, prog, spans, task, group)
    run.window_s = time.perf_counter() - start
    if trace:
        prof = _repetition(run, prog, spans, task, group, traced=True)
        if prof is not None:
            run.trace = tracing.summarize(prof)
    if device.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if group is not None:
        _gather(run, device)
    run.counters = _delta(prog.counters(), before)
    run.results = prog.results() if leader else None
    prog.release()
    return run


def agree(group, decision, device):
    """Rank 0's `decision` on every rank of `group` (a broadcast of the
    harness's own; `decision` itself for a single process)."""
    if group is None:
        return decision
    import torch
    import torch.distributed as dist

    flag = torch.tensor([1 if decision else 0], dtype=torch.int64,
                        device=device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _gather(run, device):
    """The group's readings on every rank: the largest peak of the
    ranks, and the traced window's device busy time and length as the
    means of the ranks' (`rank_busy_s`, `rank_window_s` keep each rank's;
    rank 0's summary keeps its own breakdown)."""
    import torch
    import torch.distributed as dist

    peak = torch.tensor([run.peak_bytes], dtype=torch.int64, device=device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    run.peak_bytes = int(peak.item())
    if run.trace is None:
        return
    mine = torch.tensor([run.trace.busy_s, run.trace.window_s],
                        dtype=torch.float64, device=device)
    every = [torch.empty_like(mine) for _ in range(run.world)]
    dist.all_gather(every, mine)
    run.rank_busy_s, run.rank_window_s = (
        [float(x[i]) for x in every] for i in range(2))
    run.trace.busy_s = sum(run.rank_busy_s) / run.world
    run.trace.window_s = sum(run.rank_window_s) / run.world


def _repetition(run, prog, spans, task, group=None, traced=False):
    """One repetition of the task, sampled, scanned and reduced under the
    harness's spans, recorded in `run`; `traced` runs it under
    `torch.profiler` and returns the profile. A repetition that raises
    (NaN correlations, the energy guard) is recorded as failed; under a
    group an error of the group itself ends the run."""
    import torch

    index = len(run.reps)
    rec = {"index": index, "ntraj": int(task["batch_size"]),
           "steps": int(task["num_steps"]), "failed": False,
           "traced": traced}
    profiler = tracing.profiler() if traced else contextlib.nullcontext()
    prof = None
    try:
        with profiler as prof:
            if traced:
                # the ranks' profilers start apart: the traced window of
                # each opens together, or a rank that starts first counts
                # its wait in the first collective as busy
                agree(group, True, run.device)
            with torch.profiler.record_function("bench.traced"):
                with spans(rec, "sample"):
                    prog.sample(traffic.normals(task, run.seed,
                                                traffic.WINDOW, index,
                                                run.rank, run.device))
                with spans(rec, "scan"):
                    out = prog.scan(norm_span=lambda: spans(rec, "norm"))
                with spans(rec, "reduce"):
                    prog.reduce(out)
        run.outputs.append(out)
    except RuntimeError as exc:
        if group is not None and isinstance(
                exc, torch.distributed.DistError):
            raise
        rec["failed"] = True
        rec["error"] = str(exc)
        run.outputs.append(None)
    run.reps.append(rec)
    return prof
