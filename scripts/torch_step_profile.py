#!/usr/bin/env python
# coding: utf-8
"""Per-step time, kernel launches and device idle share of the port's HK
and WM steps on one NVIDIA GPU, on one of three examples:

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
  time per step (the sum of the kernels' durations), the device's busy
  share of the traced wall and of the untraced step, and the largest
  kernels by device time.

With `--error-bars` each propagator also runs with the per-step second
moments of the error bars (keys "HK error_bars", "WM error_bars"; the
windows in turns plain, error bars, error bars, plain), so the two
reductions' launches and ms per step read as the differences.

Prints one JSON object, and writes it to `--out` if given.

    python scripts/torch_step_profile.py [--example as|coumarin|methylium]
        [--ntraj N] [--steps 48] [--window 200] [--error-bars]
        [--out profile.json]
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def _propagator(name, G, q0, potential, ntraj, seed):
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    if name == "WM":
        prop = WaltonManolopoulosPropagator(G, G, 1e4, 1e4, device="cuda")
    else:
        prop = HermanKlukPropagator(G, G, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    prop.initial_conditions(q0, 0 * q0, G, potential, ntraj=ntraj,
                            generator=gen)
    return prop


def _window_ms(prop, potential, dt, steps, m2_mode=False):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prop._run(potential, dt, steps, m2_mode=m2_mode)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _trace(prop, potential, dt, steps, m2_mode=False):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prop._run(potential, dt, steps, m2_mode=m2_mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step": busy_us / 1e3 / steps,
        "traced_ms_per_step": wall * 1e3 / steps,
        "busy_share_traced": busy_us / 1e6 / wall if kernels else None,
        "top_kernels_ms_per_step": [(name[:90], us / 1e3 / steps)
                                    for name, us in top],
    }


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
        potential, q0, _, G, _, _ = cli._build_potential(task, "cuda")
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
    potential, q0, _, G, _, _ = cli._build_potential(task, "cuda")
    return potential, q0, G


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--example", choices=("as", "coumarin", "methylium"),
                        default="as")
    parser.add_argument("--ntraj", type=int, default=None)
    parser.add_argument("--steps", type=int, default=48)
    parser.add_argument("--window", type=int, default=200)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--error-bars", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli, units
    from semiclassical_tpu_torch.ops import det, det_block, gj, wm_diag

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
    # (label, propagator, second moments of the error bars)
    runs = [(name, name, False) for name in props]
    if args.error_bars:
        runs = [run for name in props for run in
                ((name, name, False), (f"{name} error_bars", name, True))]
    for prop in props.values():
        prop._run(potential, dt, 20)                  # warm-up
    windows = {label: [] for label, _, _ in runs}
    for label, name, m2 in runs + runs[::-1]:
        windows[label].append(_window_ms(props[name], potential, dt,
                                         args.window, m2))
    result = {"device": smi, "example": args.example,
              "ntraj": args.ntraj, "dim": int(q0.shape[0]),
              "window_steps": args.window, "traced_steps": args.steps}

    def counts():
        return {"K1": det.LAUNCHES, "K2": gj.LAUNCHES["det_solve"],
                "K3": gj.LAUNCHES["det_inv"], "K4": det_block.LAUNCHES,
                "K5": wm_diag.LAUNCHES}

    for label, name, m2 in runs:
        before = counts()
        trace = _trace(props[name], potential, dt, args.steps, m2)
        after = counts()
        ms = windows[label]
        trace.update(
            ms_per_step_windows=ms,
            busy_share_untraced=trace["device_ms_per_step"] / min(ms),
            traj_steps_per_s=args.ntraj / (min(ms) / 1e3),
            launches_per_step={k: (after[k] - before[k]) / args.steps
                               for k in after})
        result[label] = trace
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
