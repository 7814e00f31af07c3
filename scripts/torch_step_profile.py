#!/usr/bin/env python
# coding: utf-8
"""Per-step time, kernel launches and device time of the port's HK and WM
steps on one NVIDIA GPU, on one of three examples:

* `--example as` (default): the 60-mode anharmonic AS example
  (examples/as_model: make_model.py's model, rng seed 42, 60 modes, chi
  0.02), 98,304 trajectories by default, the example's own;
* `--example coumarin`: the sGDML example (examples/coumarin_gdml/
  semi.json: float32 Hessian, hessian_eval "taylor", taylor_every 8), 2048
  trajectories by default, the example's own; the window restarts at the
  head of every timed or traced run, so make `--window` and `--steps`
  multiples of 8;
* `--example methylium`: the molecular harmonic example
  (examples/methylium_AH/semi.json, dense widths at rank 6), 10,000
  trajectories by default, one batch of the example.

It builds the task's potential through the port's CLI, samples one batch
with HK and with WM (cell width 1e4), and for each:

* times `--window` steps on the host clock around a synchronised run
  (twice, in turns HK, WM, WM, HK);
* traces `--steps` steps with torch.profiler: kernels per step, device
  time per step (the sum of the kernels' durations) and the largest
  kernels by device time.

With `--error-bars` each propagator also runs with the per-step second
moments of the error bars (keys "HK error_bars", "WM error_bars"; the
windows in turns plain, error bars, error bars, plain), so the two
reductions' launches and ms per step read as the differences. With
`--integrator exact` (methylium: the exact harmonic map; as: the exact
Morse map) each propagator also runs with the exact integrator on the same
batch (keys "HK exact", "WM exact", the windows in turns with the RK4
ones), and "exact_rk4_routed" counts the Morse map's RK4-routed rows. With
`--precision mixed|comp32|f32` each propagator also runs in that mode of
the CLI on the same draws, its potential in the mode's form (keys "HK
mixed", "WM mixed", ..., the windows in turns with the f64 ones), and each
run's entry names the dtypes of q, Z and S and the launches per step by
dtype. Given together with `--integrator exact`, the mode's runs take the
exact integrator (keys "HK exact comp32", ...; "exact_rk4_routed_<mode>"
counts their routed rows). With `--hessian-eval step|taylor` (and
`--taylor-every N`, taylor only) each propagator also runs with the
potential's reduced-cost Hessian at f64 (keys "HK taylor every 8", "WM
step", ..., the windows in turns with the "stage" ones; the taylor window
restarts at the head of every timed or traced run, so make `--window` and
`--steps` multiples of N). With `--micro-batch N` a WM propagator also runs
with `micro_batch` N (key "WM micro_batch N").

Every run goes through the time loop as the port runs it: on the card its
blocks are captured CUDA graphs (`propagation.graph`), replayed. With
`--eager` each run also runs under `graph.eager()` on a copy of the same
batch (keys "<run> eager"), timed in turns with its graph run (graph,
eager, eager, graph), and "graph_vs_eager" gives the largest difference of
their states (q and S, each of its own largest modulus) after the same
steps. Each run's entry has "replays_per_step", "eager_blocks",
"captures" and "capture_s" (capture plus instantiate, host clock) of its
traced steps and its first two blocks, and "peak_gb": the memory the
first two blocks (the eager warm-up, the capture and the first replay)
allocated above what was allocated before them. `--blocks 5,10,20,...`
times the graph runs of the first propagator at each block length B (key
"block_sweep": ms per step and capture seconds per B).

Prints one JSON object, and writes it to `--out` if given.

    python scripts/torch_step_profile.py [--example as|coumarin|methylium]
        [--ntraj N] [--steps 40] [--window 200] [--error-bars]
        [--integrator rk4|exact] [--precision mixed|comp32|f32]
        [--hessian-eval step|taylor] [--taylor-every N]
        [--micro-batch N] [--eager] [--blocks B1,B2,...]
        [--out profile.json]
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def _propagator(name, G, q0, potential, ntraj, seed, integrator="rk4",
                dtypes=(torch.float64, torch.float64)):
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    dtype, traj_dtype = dtypes
    if name == "WM":
        prop = WaltonManolopoulosPropagator(G, G, 1e4, 1e4, device="cuda",
                                            integrator=integrator,
                                            dtype=dtype,
                                            traj_dtype=traj_dtype)
    else:
        prop = HermanKlukPropagator(G, G, device="cuda",
                                    integrator=integrator, dtype=dtype,
                                    traj_dtype=traj_dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    prop.initial_conditions(q0, 0 * q0, G, potential, ntraj=ntraj,
                            generator=gen)
    return prop


def _mode(eager):
    from semiclassical_tpu_torch.propagation import graph

    return graph.eager() if eager else contextlib.nullcontext()


def _window_ms(prop, potential, dt, steps, m2_mode=False, eager=False):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _mode(eager):
        prop._run(potential, dt, steps, m2_mode=m2_mode)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _stats_delta(before):
    from semiclassical_tpu_torch.propagation import graph

    return {k: graph.STATS[k] - before[k] for k in before}


def _first_blocks(prop, potential, dt, m2_mode=False, eager=False):
    """Two blocks of the loop from the propagator's current state (the
    eager warm-up, then the capture and its first replay): the loop's
    counters and the memory allocated above what was allocated before."""
    from semiclassical_tpu_torch.propagation import graph

    every = int(getattr(potential, "taylor_every", 1) or 1)
    block = graph.block_lengths(graph.BLOCK_STEPS * every, every)[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(graph.STATS)
    with _mode(eager):
        prop._run(potential, dt, 2 * block, m2_mode=m2_mode)
    torch.cuda.synchronize()
    out = _stats_delta(before)
    out["peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    return out


def _trace(prop, potential, dt, steps, m2_mode=False, eager=False):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from semiclassical_tpu_torch.propagation import graph

    torch.cuda.synchronize()
    before = dict(graph.STATS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, _mode(eager):
        t0 = time.perf_counter()
        prop._run(potential, dt, steps, m2_mode=m2_mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    loop = _stats_delta(before)
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "traced_ms_per_step": wall * 1e3 / steps,
        "top_kernels_ms_per_step": [(name[:90], us / 1e3 / steps)
                                    for name, us in top],
        "replays_per_step": loop["replays"] / steps,
        "traced_loop": loop,
    }


def _graph_vs_eager(prop, twin):
    """The largest differences of two propagators' q and S, each of the
    reference's largest modulus."""
    out = {}
    for name in ("q", "S"):
        a = getattr(prop.state, name).double()
        b = getattr(twin.state, name).double()
        out[name] = float((a - b).abs().max() / b.abs().max())
    return out


def _as_potential(cli):
    """The AS example's potential, wavepacket centre and widths."""
    with tempfile.TemporaryDirectory() as tmp:
        model = pathlib.Path(tmp) / "AS_model.dat"
        with open(model, "w") as f:
            subprocess.run([sys.executable,
                            str(ROOT / "examples" / "as_model"
                                / "make_model.py")], stdout=f, check=True)
        task = {"potential": {"type": "anharmonic AS",
                              "model_file": str(model)}}
        potential, q0, _, G, _, _, _ = cli._build_potential(task, "cuda")
    return potential, q0, G


def _json_potential(cli, example):
    """The potential, wavepacket centre and widths of the first task of
    examples/`example`/semi.json (coumarin_gdml: the sGDML example;
    methylium_AH: the molecular harmonic one)."""
    example = ROOT / "examples" / example
    with open(example / "semi.json") as f:
        task = json.load(f)["semi"][0]
    for key in ("ground", "excited", "coupling"):
        task["potential"][key] = str(example / task["potential"][key])
    potential, q0, _, G, _, _, _ = cli._build_potential(task, "cuda")
    return potential, q0, G


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--example", choices=("as", "coumarin", "methylium"),
                        default="as")
    parser.add_argument("--ntraj", type=int, default=None)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--window", type=int, default=200)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--error-bars", action="store_true")
    parser.add_argument("--integrator", choices=("rk4", "exact"),
                        default="rk4")
    parser.add_argument("--precision", choices=("mixed", "comp32", "f32"),
                        default=None)
    parser.add_argument("--hessian-eval", choices=("step", "taylor"),
                        default=None)
    parser.add_argument("--taylor-every", type=int, default=1)
    parser.add_argument("--micro-batch", type=int, default=0)
    parser.add_argument("--eager", action="store_true")
    parser.add_argument("--blocks", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if args.integrator == "exact" and args.example == "coumarin":
        parser.error("the exact integrators cover the 'as' and 'methylium' "
                     "examples")
    if args.hessian_eval and args.example != "as":
        parser.error("--hessian-eval profiles the AS model's reduced-cost "
                     "Hessian (the coumarin example ships with its own)")
    if args.taylor_every < 1 or (args.taylor_every > 1
                                 and args.hessian_eval != "taylor"):
        parser.error("--taylor-every N >= 1, above 1 with --hessian-eval "
                     "taylor only")
    if not torch.cuda.is_available():
        print("torch_step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli, units
    from semiclassical_tpu_torch.ops import launch_counts
    from semiclassical_tpu_torch.propagation import graph

    if args.ntraj is None:
        args.ntraj = {"as": 98304, "coumarin": 2048,
                      "methylium": 10000}[args.example]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    if args.example == "as":
        potential, q0, G = _as_potential(cli)
    else:
        potential, q0, G = _json_potential(
            cli, {"coumarin": "coumarin_gdml",
                  "methylium": "methylium_AH"}[args.example])
    dt = 0.005 / units.autime_to_fs

    props = {name: _propagator(name, G, q0, potential, args.ntraj, args.seed)
             for name in ("HK", "WM")}
    potentials = {name: potential for name in props}
    # (label, propagator, second moments of the error bars)
    runs = [(name, name, False) for name in props]
    if args.error_bars:
        # a twin propagator each: a loop's graphs belong to one error-bar
        # mode
        for name in ("HK", "WM"):
            props[f"{name} error_bars"] = copy.deepcopy(props[name])
            potentials[f"{name} error_bars"] = potential
        runs = [run for name in ("HK", "WM") for run in
                ((name, name, False),
                 (f"{name} error_bars", f"{name} error_bars", True))]
    if args.integrator == "exact":
        for name in ("HK", "WM"):
            props[f"{name} exact"] = _propagator(name, G, q0, potential,
                                                 args.ntraj, args.seed,
                                                 "exact")
            runs.append((f"{name} exact", f"{name} exact", False))
            potentials[f"{name} exact"] = potential
    if args.precision:
        dtypes = cli._precision_dtypes(args.precision)
        mode_potential = cli._reduced_potential(potential, dtypes[0])
        exact = " exact" if args.integrator == "exact" else ""
        for name in ("HK", "WM"):
            label = f"{name}{exact} {args.precision}"
            props[label] = _propagator(name, G, q0, mode_potential,
                                       args.ntraj, args.seed,
                                       args.integrator, dtypes)
            potentials[label] = mode_potential
            runs.append((label, label, False))
    if args.hessian_eval:
        reduced = dataclasses.replace(potential,
                                      hessian_eval=args.hessian_eval,
                                      taylor_every=args.taylor_every)
        every = (f" every {args.taylor_every}" if args.taylor_every > 1
                 else "")
        for name in ("HK", "WM"):
            label = f"{name} {args.hessian_eval}{every}"
            props[label] = _propagator(name, G, q0, reduced, args.ntraj,
                                       args.seed)
            potentials[label] = reduced
            runs.append((label, label, False))
    if args.micro_batch:
        label = f"WM micro_batch {args.micro_batch}"
        props[label] = _propagator("WM", G, q0, potential, args.ntraj,
                                   args.seed)
        props[label].micro_batch = args.micro_batch
        potentials[label] = potential
        runs.append((label, label, False))
    # (label, propagator, second moments, eager)
    runs = [(*run, False) for run in runs]
    if args.eager:
        for label, name, m2, _ in list(runs):
            props[f"{name} eager"] = copy.deepcopy(props[name])
            potentials[f"{name} eager"] = potentials[name]
            runs.insert(runs.index((label, name, m2, False)) + 1,
                        (f"{label} eager", f"{name} eager", m2, True))
    result = {"device": smi, "example": args.example,
              "ntraj": args.ntraj, "dim": int(q0.shape[0]),
              "window_steps": args.window, "traced_steps": args.steps,
              "block_steps": graph.BLOCK_STEPS}
    first = {label: _first_blocks(props[name], potentials[name], dt, m2,
                                  eager)
             for label, name, m2, eager in runs}
    windows = {label: [] for label, *_ in runs}
    for label, name, m2, eager in runs + runs[::-1]:
        windows[label].append(_window_ms(props[name], potentials[name], dt,
                                         args.window, m2, eager))

    def counts():
        return {f"{k} {dtype}": n for k, counts in launch_counts().items()
                for dtype, n in counts.items()}

    for label, name, m2, eager in runs:
        before = counts()
        trace = _trace(props[name], potentials[name], dt, args.steps, m2,
                       eager)
        after = counts()
        ms = windows[label]
        state = props[name].state
        trace.update(
            ms_per_step_windows=ms,
            traj_steps_per_s=args.ntraj / (min(ms) / 1e3),
            dtypes={k: str(getattr(state, k).dtype).removeprefix("torch.")
                    for k in ("q", "Z", "S")},
            launches_per_step={k: (after[k] - before[k]) / args.steps
                               for k in after if after[k] > before[k]},
            first_blocks=first[label])
        result[label] = trace
    for label, name, _, eager in runs:
        if eager:
            result[label]["graph_vs_eager"] = _graph_vs_eager(
                props[name.removesuffix(" eager")], props[name])
    if args.blocks:
        label, name, m2, _ = runs[0]
        sweep = {}
        for block in (int(b) for b in args.blocks.split(",")):
            graph.BLOCK_STEPS = block
            before = dict(graph.STATS)
            props[name]._run(potentials[name], dt, 2 * block, m2_mode=m2)
            steps = block * max(1, args.window // block)
            ms = [_window_ms(props[name], potentials[name], dt, steps, m2)
                  for _ in range(2)]
            sweep[block] = dict(ms_per_step_windows=ms,
                                **_stats_delta(before))
        result["block_sweep"] = {"run": label, **sweep}
    for label, key in (("HK exact", "exact_rk4_routed"),
                       (f"HK exact {args.precision}",
                        f"exact_rk4_routed_{args.precision}")):
        if label in props and props[label]._morse is not None:
            sub = props[label]._morse.pack.sub_idx
            result[key] = 0 if sub is None else int(sub.numel())
    result["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
