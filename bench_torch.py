#!/usr/bin/env python3
# coding: utf-8
"""Throughput benchmark of the PyTorch/CUDA port (semiclassical_tpu_torch):
the three production configurations of the JAX package's `bench.py`, in
one process, on one NVIDIA GPU.

    python3 bench_torch.py                  # on the card, full size
    python3 bench_torch.py --device cpu     # on the CPU, bench.py's CPU sizes
    python3 bench_torch.py --eager          # every step launched from the host

It prints one JSON line per bench in the order wm, gdml, hk (the headline
prints last, for last-line parsers), each

    {"metric": "<name>_traj_steps_per_sec_per_chip", "value": N,
     "unit": "traj-steps/s/chip", "config": {...}, "phases": {...},
     "device": "<card name>, <power limit>", "peak_gb": x,
     "launches": {"K1": n, ..., "K7": n}, "launches_by_dtype": {...},
     "loop": "graph" | "eager", "graph": {...}}

1. `hk_as60` — Herman-Kluk on the 60-mode anharmonic AS model (the JAX
   package's flagship, `__graft_entry__.py`'s model), comp32 trajectories
   with float32 algebra, 1,048,576 trajectories x 500 steps of 0.25 a.u.
   One unit of the metric is one trajectory, with its monodromy, advanced
   one RK4 step with both observables C(t), k~ic(t) accumulated; the
   diagonal monodromy step launches K6 once a step (as in `wm_as60`).
2. `wm_as60` — Walton-Manolopoulos on the same model (alpha = beta = 1e4),
   comp32, 524,288 x 500; the separable WM step launches K5 once a step.
3. `gdml_coumarin` — HK on the sGDML coumarin model (51 Cartesians, rank
   45), float32 algebra with float64 trajectories (mixed) and a float32
   Hessian, `hessian_eval` "taylor" with `taylor_every` 32, 32,768 x 100
   steps of 0.1 a.u.; the prefactor's (n, 45, 45) complex64 determinant
   launches K4 once a step.

Each bench times its phases on `profiling.PhaseTimer` (the card synced at
each phase end): `sample` (model, potential, propagator, draw), `warmup`
(`warm_up`: the full `nt` steps with the bench's `micro_batch`, as
bench.py's compile run, which builds the kernels, warms the allocator and
captures the time loop's blocks, then the batch drawn again from a
generator at the same seed), `scan` (the timed `nt` steps) and `reduce`
(C(t) and k~ic(t) checked finite). `launches` counts the kernel launches
of the scan phase (`ops.launch_counts()`), `peak_gb` is
`torch.cuda.max_memory_allocated` over the bench. On the card the scan
runs as the port runs it, in blocks of steps captured as CUDA graphs and
replayed (`propagation.graph`); the batch drawn anew runs through the
loop the warm-up captured, which the process keeps, so the scan only
replays: "graph" counts the scan's replays, captures (with their capture
plus instantiate seconds) and eager blocks, and shows 0 captures and 0
eager blocks. The loop is dropped (`graph.clear`) after each bench.
`--eager` runs every bench under `graph.eager()`, every launch of every
step from the host ("loop": "eager").

Environment, as bench.py reads it: BENCH_ONLY (hk | wm | gdml), BENCH_DTYPE
(hk: comp32 | mixed | float32 | float64), BENCH_NTRAJ, BENCH_NT,
BENCH_WM_NTRAJ, BENCH_WM_NT, BENCH_WM_MICRO, BENCH_GDML_NTRAJ,
BENCH_GDML_NT, BENCH_GDML_MICRO (micro_batch: none by default, the whole
batch at once), SEMI_REF_DATA (a directory with GDML/ and Gaussian16/;
default tests/data/refdata).

No fallback hides a fault: without CUDA the script stops unless given
`--device cpu`; an out-of-memory error is an error (no smaller retry); a
bench that raises prints {"metric": "<name>_bench_error", "error": ...}
and the script exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import traceback
from dataclasses import dataclass

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 0
AS60_DIM = 60
AS60_DT = 0.25         # a.u.; stable for the stiffest 3000 cm^-1 mode
GDML_DT = 0.1          # a.u.
GDML_TAYLOR_EVERY = 32
GDML_MODEL = os.path.join(
    "GDML", "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
GDML_FCHK = os.path.join("Gaussian16", "coumarin_s1.fchk")
# the gdml bench's sub-batch on the card: none. A trajectory of a 2048 run
# peaks at 0.48 MB (torch.cuda.max_memory_allocated on an H100 80GB), so
# the whole 32,768 take ~16 GB, far under the ~60 GB a sub-batch would
# be sized to (PERF.md)
GDML_MICRO_DEFAULT = None
EXEC_ORDER = ("hk", "wm", "gdml")    # the largest batch first
PRINT_ORDER = ("wm", "gdml", "hk")   # the headline last
# BENCH_DTYPE: (algebra dtype, trajectory dtype)
HK_MODES = {"comp32": (torch.float32, "comp32"),
            "mixed": (torch.float32, torch.float64),
            "float32": (torch.float32, torch.float32),
            "float64": (torch.float64, torch.float64)}


@dataclass
class BenchResult:
    """One bench's JSON line, its curves (C(t), k~ic(t)) and, until the
    caller drops them, the propagator and potential after the run."""

    line: dict
    curves: tuple
    prop: object = None
    potential: object = None


def _env_int(name, default):
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def resolve_device(name):
    """The torch device the benches run on; a CUDA device without CUDA
    stops the run (no move to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "bench_torch: CUDA is not available; the benches run on the "
            "card (pass --device cpu to run them on the CPU)")
    return device


def device_line(device):
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def launches_between(before, after):
    """(launches per kernel, launches by dtype of the kernels launched)
    between two `ops.launch_counts()`."""
    by_dtype = {k: {t: after[k][t] - before[k][t] for t in after[k]}
                for k in after}
    totals = {k: sum(by_dtype[k].values()) for k in after}
    return totals, {k: v for k, v in by_dtype.items() if totals[k]}


# ---------------------------------------------------------------------------
# the configurations
# ---------------------------------------------------------------------------

def as60_model():
    """The 60-mode anharmonic AS model (omega, S, nac, chi, dQ) in atomic
    units: default_rng(42); omega ~ U(200, 3000) cm^-1, S ~ U(0.01, 0.3),
    nac ~ U(-1, 1) drawn in that order, chi = 0.02, dQ = sqrt(2 S / omega)."""
    rng = np.random.default_rng(42)
    omega = rng.uniform(200.0, 3000.0, size=AS60_DIM) / 219474.63
    S = rng.uniform(0.01, 0.3, size=AS60_DIM)
    nac = rng.uniform(-1.0, 1.0, size=AS60_DIM)
    chi = np.full(AS60_DIM, 0.02)
    return omega, S, nac, chi, np.sqrt(2.0 * S / omega)


def as60_setup(ntraj, device, propagator="HK", dtype=torch.float64,
               traj_dtype=None, normals=None, group=None):
    """(propagator, potential) of the AS60 model with its batch drawn: HK,
    or WM at alpha = beta = 1e4. The Morse parameters live at the algebra
    `dtype`, so under comp32 and mixed its transcendentals run in float32.
    The draw comes from a generator at SEED on `device`, or from
    `normals` ((ntraj, 120) standard normals)."""
    from semiclassical_tpu_torch.potentials import MorsePotential
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    omega, _, nac, chi, dQ = as60_model()
    pot = MorsePotential.create(omega, chi, nac, device=device, dtype=dtype)
    Gamma = np.diag(omega)
    if propagator == "WM":
        prop = WaltonManolopoulosPropagator(Gamma, Gamma, 1e4, 1e4, device,
                                            dtype=dtype, traj_dtype=traj_dtype)
    elif propagator == "HK":
        prop = HermanKlukPropagator(Gamma, Gamma, device, dtype=dtype,
                                    traj_dtype=traj_dtype)
    else:
        raise ValueError(f"unknown propagator {propagator!r} (HK or WM)")
    draw(prop, pot, dQ, Gamma, ntraj, normals, group)
    return prop, pot


def draw(prop, pot, q0, Gamma, ntraj, normals=None, group=None):
    """Draw the batch of `prop` (at rest at q0, width Gamma) from a fresh
    generator at SEED on the propagator's device, or from `normals`."""
    generator = None
    if normals is None:
        generator = torch.Generator(device=prop.device).manual_seed(SEED)
    prop.initial_conditions(q0, np.zeros_like(q0), Gamma, pot, ntraj=ntraj,
                            generator=generator, normals=normals, group=group)


def gdml_fixture_dir():
    """The directory holding GDML/ and Gaussian16/ (SEMI_REF_DATA, then the
    repo's tests/data/refdata); a missing fixture is an error."""
    candidates = [os.environ.get("SEMI_REF_DATA"),
                  os.path.join(REPO, "tests", "data", "refdata")]
    for c in candidates:
        if c and all(os.path.exists(os.path.join(c, f))
                     for f in (GDML_MODEL, GDML_FCHK)):
            return c
    raise FileNotFoundError(
        f"no sGDML fixture ({GDML_MODEL}, {GDML_FCHK}) under "
        f"{[c for c in candidates if c]}")


def gdml_setup(ntraj, device, normals=None, hess_dtype="float32",
               dtype=torch.float32):
    """(propagator, potential, x0, Gamma0, fixture directory) of the
    coumarin bench: the sGDML PES with `hess_dtype` and `hessian_eval`
    "taylor" every GDML_TAYLOR_EVERY steps, its origin at the minimum, HK
    with `dtype` algebra (float32: mixed) and float64 trajectories, the
    batch drawn at the vibrational ground state of the S1 fchk."""
    from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
    from semiclassical_tpu_torch.potentials import (MolecularGDMLPotential,
                                                    minimize)
    from semiclassical_tpu_torch.propagation import HermanKlukPropagator

    data = gdml_fixture_dir()
    with np.load(os.path.join(data, GDML_MODEL), allow_pickle=True) as f:
        model = dict(f)
    with open(os.path.join(data, GDML_FCHK)) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(
        model, exc, device, hess_dtype=hess_dtype, hessian_eval="taylor",
        taylor_every=GDML_TAYLOR_EVERY)
    x0, Gamma0, _ = exc.vibrational_groundstate()
    x0 = np.asarray(x0)
    pot = minimize(pot, x0)
    prop = HermanKlukPropagator(Gamma0, Gamma0, device, dtype=dtype,
                                traj_dtype=torch.float64)
    draw(prop, pot, x0, Gamma0, ntraj, normals)
    return prop, pot, x0, Gamma0, data


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def warm_up(prop, pot, dt, nt, energy0_es, micro=None):
    """The warm-up of a bench, as bench.py's compile run: the full `nt`
    steps with the bench's `micro_batch`. On the card that captures every
    block length the scan runs twice or more (a block runs eagerly at its
    first call and is captured at its second); a length the scan runs only
    once (the tail of `nt`, or `nt` below one block) runs once more here,
    so the scan replays every block."""
    from semiclassical_tpu_torch.propagation import graph

    kw = dict(energy0_es=energy0_es, check_energy=False, micro_batch=micro)
    prop.propagate(pot, dt, nt, **kw)
    lengths = graph.block_lengths(
        nt, int(getattr(pot, "taylor_every", 1) or 1))
    for length in sorted({n for n in lengths if lengths.count(n) == 1}):
        prop.propagate(pot, dt, length, **kw)


def timed_run(timer, prop, pot, redraw, dt, nt, energy0_es, micro=None):
    """The warm-up, the timed scan and the reduce of one bench on `timer`:
    (C(t), k~ic(t), launches per kernel, launches by dtype, the scan's loop
    counters). `redraw()` draws the batch anew from its
    seed after the warm-up, so the scan starts from a fresh draw, through
    the warm-up's loop."""
    from semiclassical_tpu_torch.ops import launch_counts
    from semiclassical_tpu_torch.propagation import graph

    with timer.phase("warmup"):
        warm_up(prop, pot, dt, nt, energy0_es, micro)
        redraw()
    before = launch_counts()
    loop = dict(graph.STATS)
    with timer.phase("scan"):
        cauto, kic = prop.propagate(pot, dt, nt, energy0_es=energy0_es,
                                    check_energy=False, micro_batch=micro)
    totals, by_dtype = launches_between(before, launch_counts())
    loop = {k: graph.STATS[k] - loop[k] for k in loop}
    loop["capture_s"] = round(loop["capture_s"], 3)
    with timer.phase("reduce"):
        if not (np.isfinite(cauto).all() and np.isfinite(kic).all()):
            raise FloatingPointError("C(t) or k~ic(t) is not finite")
    return cauto, kic, totals, by_dtype, loop


def _line(metric, timer, ntraj, nt, config, device, launches, by_dtype,
          loop):
    from semiclassical_tpu_torch.propagation import graph

    value = timer.throughput(ntraj * nt)
    line = {"metric": metric, "value": round(value, 1),
            "unit": "traj-steps/s/chip", "config": config,
            "phases": {k: round(v, 3) for k, v in timer.phases.items()},
            "device": device_line(device),
            "peak_gb": (round(torch.cuda.max_memory_allocated(device) / 1e9,
                              3) if device.type == "cuda" else None),
            "launches": launches, "launches_by_dtype": by_dtype,
            "loop": "graph" if graph.captures(device) else "eager",
            "graph": loop}
    return line


def _start(device):
    from semiclassical_tpu_torch.profiling import PhaseTimer

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return PhaseTimer(device)


def bench_hk(device):
    """hk_as60: HK on the AS60 model at 1,048,576 x 500 comp32 on the card
    (2048 x 100 float64 on the CPU)."""
    device = torch.device(device)
    card = device.type == "cuda"
    ntraj = _env_int("BENCH_NTRAJ", 1048576 if card else 2048)
    nt = _env_int("BENCH_NT", 500 if card else 100)
    dtype_name = os.environ.get("BENCH_DTYPE",
                                "comp32" if card else "float64")
    if dtype_name not in HK_MODES:
        raise ValueError(f"unknown BENCH_DTYPE {dtype_name!r} (expected one "
                         f"of {sorted(HK_MODES)})")
    dtype, traj_dtype = HK_MODES[dtype_name]
    timer = _start(device)
    with timer.phase("sample"):
        prop, pot = as60_setup(ntraj, device, "HK", dtype, traj_dtype)
    omega, _, _, _, dQ = as60_model()
    cauto, kic, launches, by_dtype, loop = timed_run(
        timer, prop, pot,
        lambda: draw(prop, pot, dQ, np.diag(omega), ntraj),
        AS60_DT, nt, 0.0)
    line = _line("hk_as60_traj_steps_per_sec_per_chip", timer, ntraj, nt, {
        "ntraj": ntraj, "nt": nt, "dim": AS60_DIM, "dtype": dtype_name,
        "device": str(device), "wall_s": round(timer.phases["scan"], 3),
        "warmup_s": round(timer.phases["warmup"], 1)},
        device, launches, by_dtype, loop)
    return BenchResult(line, (cauto, kic), prop, pot)


def bench_wm(device):
    """wm_as60: WM on the AS60 model at 524,288 x 500 comp32 on the card
    (2048 x 50 float64 on the CPU); micro_batch none unless BENCH_WM_MICRO
    sets it."""
    device = torch.device(device)
    card = device.type == "cuda"
    ntraj = _env_int("BENCH_WM_NTRAJ", 524288 if card else 2048)
    nt = _env_int("BENCH_WM_NT", 500 if card else 50)
    micro = _env_int("BENCH_WM_MICRO", None)
    dtype, traj_dtype = HK_MODES["comp32" if card else "float64"]
    timer = _start(device)
    with timer.phase("sample"):
        prop, pot = as60_setup(ntraj, device, "WM", dtype, traj_dtype)
    omega, _, _, _, dQ = as60_model()
    en0 = float(np.sum(0.5 * omega))
    cauto, kic, launches, by_dtype, loop = timed_run(
        timer, prop, pot,
        lambda: draw(prop, pot, dQ, np.diag(omega), ntraj),
        AS60_DT, nt, en0, micro)
    line = _line("wm_as60_traj_steps_per_sec_per_chip", timer, ntraj, nt, {
        "ntraj": ntraj, "nt": nt, "dim": AS60_DIM,
        "dtype": "comp32" if card else "float64", "micro_batch": micro,
        "device": str(device), "wall_s": round(timer.phases["scan"], 3)},
        device, launches, by_dtype, loop)
    return BenchResult(line, (cauto, kic), prop, pot)


def bench_gdml(device):
    """gdml_coumarin: sGDML HK on coumarin, mixed with a float32 Hessian,
    taylor every 32, at 32,768 x 100 on the card (256 x 8 on the CPU)."""
    device = torch.device(device)
    card = device.type == "cuda"
    ntraj = _env_int("BENCH_GDML_NTRAJ", 32768 if card else 256)
    nt = _env_int("BENCH_GDML_NT", 100 if card else 8)
    micro = _env_int("BENCH_GDML_MICRO", GDML_MICRO_DEFAULT if card else None)
    timer = _start(device)
    with timer.phase("sample"):
        prop, pot, x0, Gamma0, data = gdml_setup(ntraj, device)
    cauto, kic, launches, by_dtype, loop = timed_run(
        timer, prop, pot, lambda: draw(prop, pot, x0, Gamma0, ntraj),
        GDML_DT, nt, 0.0, micro)
    line = _line("gdml_coumarin_traj_steps_per_sec_per_chip", timer, ntraj,
                 nt, {
                     "ntraj": ntraj, "nt": nt, "n_cartesian": int(x0.size),
                     "hessian_eval": "taylor",
                     "taylor_every": GDML_TAYLOR_EVERY,
                     "micro_batch": micro, "hess_dtype": "float32",
                     "device": str(device),
                     "wall_s": round(timer.phases["scan"], 3),
                     "fixtures": os.path.relpath(data, REPO)},
                 device, launches, by_dtype, loop)
    return BenchResult(line, (cauto, kic), prop, pot)


BENCHES = {"hk": bench_hk, "wm": bench_wm, "gdml": bench_gdml}


def run_benches(device, only="", on_result=None):
    """Run the benches in EXEC_ORDER (only `only` if given) and return
    {name: BenchResult, or the error line of a bench that raised}.
    `on_result(name, result)` sees each result while its propagator is
    alive; the propagator and the time loop the process keeps for it are
    dropped before the next bench starts."""
    from semiclassical_tpu_torch.propagation import graph

    if only and only not in BENCHES:
        raise ValueError(f"unknown bench {only!r} (expected one of "
                         f"{sorted(BENCHES)})")
    device = torch.device(device)
    results = {}
    for name in EXEC_ORDER:
        if only and name != only:
            continue
        try:
            result = BENCHES[name](device)
            if on_result is not None:
                on_result(name, result)
            result.prop = result.potential = None
            results[name] = result
        except Exception as exc:
            traceback.print_exc()
            results[name] = {"metric": f"{name}_bench_error",
                             "error": repr(exc)}
        result = None
        graph.clear(device)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run every bench under graph.eager(): every launch "
                         "of every step from the host, no CUDA graph")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from semiclassical_tpu_torch.propagation import graph

    with graph.eager() if args.eager else contextlib.nullcontext():
        results = run_benches(device, os.environ.get("BENCH_ONLY", ""))
    for name in PRINT_ORDER:
        if name in results:
            r = results[name]
            print(json.dumps(r.line if isinstance(r, BenchResult) else r),
                  flush=True)
    failed = [n for n, r in results.items() if not isinstance(r, BenchResult)]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
