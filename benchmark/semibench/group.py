"""A cell on several cards: one process a card, joined in one
`torch.distributed` group by the port's own `parallel.init_group` (NCCL
on the cards, gloo on the CPU), each rank on `cuda:{rank}`.

Rank 0 is the process `run.py` started. It writes the job (the cell as
loaded, the seed, the window) into a fresh directory under TMPDIR, starts
ranks 1 to world - 1 as `run.py --rank <r> --job <file>`, and every rank
joins the group through a `file://` store in that directory. Each rank
then runs `window.execute` with its group. When the group's work is done
every rank takes part in the release (`release`), which also gathers the
forbidden modules (`guard`) each rank holds as its window closed; rank 0
waits for the others to end, and alone goes on to the check and the
result's line. The other ranks write nothing to standard output (theirs
is the run's standard error).

Deadlines. Every collective, the port's and the harness's, fails after
COLLECTIVE_S seconds (the group's timeout). Each process's Watchdog ends
the run, and gives its exit code, in one place (`Watchdog.end`): with
EXIT_RANK_LOST as soon as a rank has ended before the release (rank 0
looks every POLL_S seconds, and once more when a collective fails), or
when rank 0 has gone (the other ranks); with EXIT_DEADLINE once SETUP_S
seconds have passed since its start and set-up has not ended (a first run
builds the kernels), or once the window's seconds and AFTER_SETUP_S more
have passed since set-up ended (the window, the traced repetition and
rank 0's check)."""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from semibench import guard, program, window
from semibench.cell import Cell

RUN_PY = pathlib.Path(__file__).resolve().parents[1] / "run.py"
COLLECTIVE_S = 180.0
POLL_S = 0.2
SETTLE_S = 1.0
SETUP_S = 1100.0
AFTER_SETUP_S = 300.0
JOIN_S = 60.0
EXIT_RANK_LOST, EXIT_DEADLINE = 5, 6


def _device(device_type, rank):
    import torch

    return (torch.device("cuda", rank) if device_type == "cuda"
            else torch.device(device_type))


class Watchdog(threading.Thread):
    """Ends this process, and the ranks it started, at the deadline, when
    one of those ranks ends before `release()`, or when the process that
    started this one has gone (`parent`)."""

    def __init__(self, t0, children=(), parent=None, workdir=None):
        super().__init__(daemon=True)
        self.deadline = t0 + SETUP_S
        self.children, self.parent, self.workdir = children, parent, workdir
        self.released = False

    def after_setup(self, seconds):
        self.deadline = time.perf_counter() + seconds + AFTER_SETUP_S

    def release(self):
        self.released = True

    def run(self):
        while True:
            time.sleep(POLL_S)
            self.look()

    def look(self):
        """End the run if its deadline has passed or a rank has gone."""
        if time.perf_counter() > self.deadline:
            self.end(EXIT_DEADLINE, "the group's run passed its deadline")
        if self.parent is not None and os.getppid() != self.parent:
            self.end(EXIT_RANK_LOST, "rank 0 has ended")
        for rank, proc in self.children:
            code = proc.poll()
            if code is not None and (code or not self.released):
                self.end(EXIT_RANK_LOST, f"rank {rank} ended with code "
                         f"{code} before the group's work was done")

    def settle(self):
        """One more look once a collective has failed, the ranks given
        SETTLE_S seconds to end (a rank that is going down)."""
        end = time.perf_counter() + SETTLE_S
        for _, proc in self.children:
            try:
                proc.wait(timeout=max(end - time.perf_counter(), 0.0))
            except subprocess.TimeoutExpired:
                pass
        self.look()

    def end(self, code, why):
        print(f"group: {why}; ending the run", file=sys.stderr, flush=True)
        stop(self.children)
        if self.workdir is not None:
            shutil.rmtree(self.workdir, ignore_errors=True)
        os._exit(code)


def stop(children):
    """Kill each rank that still runs and wait for it to end."""
    for _, proc in children:
        if proc.poll() is None:
            proc.kill()
    for _, proc in children:
        proc.wait()


def release(group, device):
    """The group's last collective, on every rank once its window has
    closed: each rank's forbidden modules, the largest over the ranks (an
    all-reduce of the harness's own); returns the names any rank holds."""
    import torch
    import torch.distributed as dist

    held = set(guard.forbidden_modules())
    flags = torch.tensor([name in held for name in guard.FORBIDDEN],
                         dtype=torch.int64, device=device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    return [name for name, flag in zip(guard.FORBIDDEN, flags.tolist())
            if flag]


def execute(cell, seed, seconds, trace, device_type, t0, system=None,
            max_reps=None):
    """Rank 0 of a group of `cell.chips` ranks: start the others, run the
    window with them, release them and wait for them; returns rank 0's
    Run. `system` names a Program in the port's place on every rank
    (`program.load`)."""
    import torch

    from semiclassical_tpu_torch.parallel import destroy_group, init_group

    world = cell.chips
    workdir = tempfile.mkdtemp(prefix="bench-group-")
    job = {"cell": dataclasses.asdict(cell), "seed": seed,
           "seconds": seconds, "trace": trace, "device": device_type,
           "max_reps": max_reps, "system": system, "world": world,
           "threads": torch.get_num_threads(), "parent": os.getpid(),
           "store": f"file://{workdir}/store"}
    path = os.path.join(workdir, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    children = []
    watchdog = Watchdog(t0, children, workdir=workdir)
    try:
        for rank in range(1, world):
            children.append((rank, subprocess.Popen(
                [sys.executable, str(RUN_PY), "--rank", str(rank), "--job",
                 path], stdout=2)))
        watchdog.start()
        device = _device(device_type, 0)
        group = init_group(job["store"], world, 0, device=device,
                           timeout=COLLECTIVE_S)
        run = window.execute(cell, seed, seconds, trace, device, t0,
                             system=program.load(system), max_reps=max_reps,
                             group=group,
                             on_setup=lambda: watchdog.after_setup(seconds))
        watchdog.release()
        run.found_on_ranks = release(group, device)
        destroy_group(group)
        for rank, proc in children:
            code = proc.wait(timeout=JOIN_S)
            if code:
                raise RuntimeError(f"rank {rank} ended with code {code}")
        return run
    except Exception:
        # a collective that failed because a rank has gone: the watchdog
        # names it and ends the run
        watchdog.settle()
        raise
    finally:
        watchdog.children = ()      # the ranks this stops are not lost
        stop(children)
        shutil.rmtree(workdir, ignore_errors=True)


def rank_main(job_path, rank, t0):
    """Rank `rank` (> 0) of the job at `job_path`, a process started at
    `t0`: join the group, run the window with it, take part in the
    release; returns the exit code."""
    import torch

    from semiclassical_tpu_torch.parallel import destroy_group, init_group

    with open(job_path) as f:
        job = json.load(f)
    watchdog = Watchdog(t0, parent=job["parent"])
    watchdog.start()
    torch.set_num_threads(job["threads"])
    device = _device(job["device"], rank)
    group = init_group(job["store"], job["world"], rank, device=device,
                       timeout=COLLECTIVE_S)
    window.execute(Cell(**job["cell"]), job["seed"], job["seconds"],
                   job["trace"], device, t0,
                   system=program.load(job["system"]),
                   max_reps=job["max_reps"], group=group,
                   on_setup=lambda: watchdog.after_setup(job["seconds"]))
    release(group, device)
    destroy_group(group)
    return 0
