#!/usr/bin/env python3
# coding: utf-8
"""Check a process group of the PyTorch port on several cards against one
process: the methylium example through `semiclassical_tpu_torch.cli` as
N processes under `--coordinator` (one per card, NCCL) and then as one
process, at the same seed.

    python3 scripts/torch_group_check.py [--procs 4] [--hk-ntraj 40000]
        [--hk-steps 500] [--wm-ntraj 10000] [--wm-steps 100] [--device cpu]

Two tasks, each run by the group and alone: HK at --hk-ntraj x
--hk-steps with the norm at the start and half way (the HK ring), and WM
(cell width 1e4) at --wm-ntraj x --wm-steps with the norm at the start
(the WM ring: K3 on every block pair of every rotation). The batch is
rounded up to a multiple of --procs, so the single process runs the
rounded count. Gates: C(t) and k~ic(t) of the group's npz within 1e-12 of
their largest modulus from the single process's, the norm lines equal to
the digits printed (the HK norm over every ordered pair against the
single process's upper triangle: equal at full rank only, so the HK lines
are printed, not gated; methylium's widths are rank-deficient). Prints
the walls of both (each with its processes' start; the kernels are built
first), the cards' names and power limits; exits non-zero on a failed
gate. It needs --procs cards: NCCL takes one rank a card
(`--device cpu` runs the same on a gloo group, at small sizes).
"""

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "methylium_AH" / "semi.json"
GATE = 1e-12


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def task_file(tmp, name, **keys):
    """The example's dynamics task with `keys`, writing `name`.npz."""
    with open(EXAMPLE) as f:
        config = json.load(f)
    task = next(t for t in config["semi"] if t["task"] == "dynamics")
    for key in ("ground", "excited", "coupling"):
        task["potential"][key] = str(
            (EXAMPLE.parent / task["potential"][key]).resolve())
    task.update(keys, manual_seed=1234,
                results={"correlations": str(tmp / f"{name}.npz"),
                         "overwrite": True})
    cfg = tmp / f"{name}.json"
    cfg.write_text(json.dumps({"semi": [task]}))
    return cfg


def run(cfg, procs, tmp, device):
    """The CLI on `cfg` as `procs` processes of a group (0: one process
    alone); returns (wall seconds, each process's output)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    base = [sys.executable, "-m", "semiclassical_tpu_torch.cli", "dynamics",
            str(cfg), "--device", device]
    if procs:
        port = free_port()
        cmds = [base + ["--coordinator", f"127.0.0.1:{port}",
                        "--num-processes", str(procs), "--process-id",
                        str(k)] for k in range(procs)]
    else:
        cmds = [base]
    t0 = time.perf_counter()
    ps = [subprocess.Popen(c, env=env, cwd=tmp, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
          for c in cmds]
    try:
        outs = [p.communicate(timeout=1800)[0] for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    wall = time.perf_counter() - t0
    for p, out in zip(ps, outs):
        if p.returncode:
            raise SystemExit(f"a process exited {p.returncode}:\n"
                             f"{out[-3000:]}")
    return wall, outs


def phases(out):
    """The PhaseTimer lines of a process's log (walls and throughput)."""
    return "; ".join(line.split("]", 1)[-1].strip()
                     for line in out.splitlines()
                     if "  phase " in line or "throughput:" in line)


def norms(out):
    return [line.split("norm=")[1].split()[0]
            for line in out.splitlines() if "norm=" in line]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--procs", type=int, default=4)
    parser.add_argument("--hk-ntraj", type=int, default=40000)
    parser.add_argument("--hk-steps", type=int, default=500)
    parser.add_argument("--wm-ntraj", type=int, default=10000)
    parser.add_argument("--wm-steps", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import torch

    if args.device == "cpu":
        smi = ["CPU (gloo)"]
    else:
        if torch.cuda.device_count() < args.procs:
            raise SystemExit(f"--procs {args.procs} needs as many cards; "
                             f"{torch.cuda.device_count()} visible")
        sys.path.insert(0, str(ROOT))
        from semiclassical_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load()   # built once here, so no run's wall holds the build
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {smi}", flush=True)
    failed = []
    tasks = (("HK", dict(batch_size=args.hk_ntraj,
                         num_trajectories=args.hk_ntraj,
                         num_steps=args.hk_steps,
                         calc_norm_every=args.hk_steps // 2)),
             ("WM", dict(propagator="WM", cell_width=1e4,
                         batch_size=args.wm_ntraj,
                         num_trajectories=args.wm_ntraj,
                         num_steps=args.wm_steps,
                         calc_norm_every=args.wm_steps)))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for label, keys in tasks:
            n = keys["batch_size"]
            n = -(-n // args.procs) * args.procs
            keys.update(batch_size=n, num_trajectories=n)
            group_wall, outs = run(task_file(tmp, f"{label}_group", **keys),
                                   args.procs, tmp, args.device)
            alone_wall, alone = run(task_file(tmp, f"{label}_alone", **keys),
                                    0, tmp, args.device)
            g = np.load(tmp / f"{label}_group.npz")
            a = np.load(tmp / f"{label}_alone.npz")
            gaps = [float(np.abs(g[k] - a[k]).max() / np.abs(a[k]).max())
                    for k in ("autocorrelation", "ic_correlation")]
            gn, an = norms(outs[0]), norms(alone[0])
            quiet = all(not norms(out) for out in outs[1:])
            steps = n * keys["num_steps"]
            print(f"{label} methylium {n} x {keys['num_steps']} steps: "
                  f"{args.procs} processes {group_wall:.3f} s "
                  f"({steps / group_wall:.0f} traj-steps/s, process start "
                  f"included), one process {alone_wall:.3f} s "
                  f"({steps / alone_wall:.0f}); C(t) {gaps[0]:.3e}, "
                  f"k~ic(t) {gaps[1]:.3e} of the largest modulus (gate "
                  f"{GATE:g}); norms {gn} against {an}; trajectories "
                  f"{int(g['trajectories'])} / {int(a['trajectories'])} "
                  f"[{smi[0]}]", flush=True)
            print(f"  rank 0: {phases(outs[0])}\n  alone: {phases(alone[0])}",
                  flush=True)
            if max(gaps) > GATE or not quiet or int(g["trajectories"]) != n:
                failed.append(label)
            if label == "WM" and gn != an:
                failed.append("WM norm")
    if failed:
        raise SystemExit(f"failed: {failed}")
    print("group check passed", flush=True)


if __name__ == "__main__":
    main()
