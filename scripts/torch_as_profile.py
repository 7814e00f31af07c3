#!/usr/bin/env python
# coding: utf-8
"""Per-step time, kernel launches and device idle share of the port's HK
and WM steps on the 60-mode anharmonic AS example, on one NVIDIA GPU.

Builds examples/as_model's model (make_model.py: rng seed 42, 60 modes,
chi 0.02) and the task's potential through the port's CLI, samples one
batch (default 98,304 trajectories, the example's own) with HK and with
WM (cell width 1e4), and for each:

* times `--window` steps on the host clock around a synchronised run
  (twice, in turns HK, WM, WM, HK);
* traces `--steps` steps with torch.profiler: kernels per step, device
  time per step (the sum of the kernels' durations), the device's busy
  share of the traced wall and of the untraced step, and the largest
  kernels by device time.

Prints one JSON object, and writes it to `--out` if given.

    python scripts/torch_as_profile.py [--ntraj 98304] [--steps 50]
        [--window 200] [--out as_profile.json]
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


def _window_ms(prop, potential, dt, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prop._run(potential, dt, steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _trace(prop, potential, dt, steps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prop._run(potential, dt, steps)
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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ntraj", type=int, default=98304)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--window", type=int, default=200)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_as_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli, units
    from semiclassical_tpu_torch.ops import wm_diag

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        model = pathlib.Path(tmp) / "AS_model.dat"
        with open(model, "w") as f:
            subprocess.run([sys.executable,
                            str(ROOT / "examples" / "as_model"
                                / "make_model.py")], stdout=f, check=True)
        task = {"potential": {"type": "anharmonic AS",
                              "model_file": str(model)}}
        potential, q0, _, G, _, _ = cli._build_potential(task, "cuda")
    dt = 0.005 / units.autime_to_fs

    props = {name: _propagator(name, G, q0, potential, args.ntraj, args.seed)
             for name in ("HK", "WM")}
    for prop in props.values():
        prop._run(potential, dt, 20)                  # warm-up
    windows = {name: [] for name in props}
    for name in ("HK", "WM", "WM", "HK"):
        windows[name].append(_window_ms(props[name], potential, dt,
                                        args.window))
    result = {"device": smi, "ntraj": args.ntraj, "dim": int(q0.shape[0]),
              "window_steps": args.window, "traced_steps": args.steps}
    for name, prop in props.items():
        launches = wm_diag.LAUNCHES
        trace = _trace(prop, potential, dt, args.steps)
        ms = windows[name]
        trace.update(
            ms_per_step_windows=ms,
            busy_share_untraced=trace["device_ms_per_step"] / min(ms),
            traj_steps_per_s=args.ntraj / (min(ms) / 1e3),
            k5_launches_per_step=(wm_diag.LAUNCHES - launches) / args.steps)
        result[name] = trace
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
