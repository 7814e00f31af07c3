#!/usr/bin/env python3
# coding: utf-8
"""Weak-scaling benchmark of the port's flagship (the AS60 model of
`bench_torch.py`, HK or WM) over a process group: one process a card, the
ranks sharing each batch (`semiclassical_tpu_torch.parallel`), so the batch
is `--ntraj-per-chip` times the group's size. The metric is
traj-steps/s/chip, which stays flat as cards are added while the step is
device-bound (the only cross-card traffic is one all-reduce of the
segment's sums).

    # one card, no group
    python3 scripts/torch_pod_bench.py --ntraj-per-chip 524288

    # N cards of one host: one process each, rank k of N
    python3 scripts/torch_pod_bench.py --coordinator 127.0.0.1:29500 \\
        --num-processes N --process-id k

    # the CPU, a gloo group of N processes (small sizes)
    python3 scripts/torch_pod_bench.py --device cpu --ntraj-per-chip 256 \\
        --nt 10 --coordinator file:///tmp/store --num-processes N \\
        --process-id k

On the card the run is comp32 with float32 algebra, on the CPU float64.
Each rank warms up (`bench_torch.warm_up`: the full `nt` steps, which
capture the time loop's blocks on the card, then the batch drawn anew at
the same seed, which runs through the kept loop) and times the scan; rank 0 prints one JSON line with the keys of
the JAX package's `scripts/pod_bench.py` and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from semiclassical_tpu_torch.parallel import (  # noqa: E402
    barrier, destroy_group, init_group, world_of)
from semiclassical_tpu_torch.profiling import PhaseTimer  # noqa: E402


def run(group, device, propagator="HK", ntraj_per_chip=524288, nt=500):
    """One weak-scaling run of this rank: (JSON line, (C(t), k~ic(t))).
    `group` is a `parallel.Group` or None (a single process)."""
    device = torch.device(device) if group is None else group.device
    nchips = world_of(group)
    ntraj = ntraj_per_chip * nchips
    dtype, traj_dtype = bench_torch.HK_MODES[
        "comp32" if device.type == "cuda" else "float64"]
    omega, _, _, _, dQ = bench_torch.as60_model()
    timer = PhaseTimer(device)
    with timer.phase("sample"):
        prop, pot = bench_torch.as60_setup(ntraj, device, propagator, dtype,
                                           traj_dtype, group=group)
    with timer.phase("warmup"):
        bench_torch.warm_up(prop, pot, bench_torch.AS60_DT, nt, 0.0)
        bench_torch.draw(prop, pot, dQ, np.diag(omega), ntraj, group=group)
        barrier(group)
    with timer.phase("scan"):
        cauto, kic = prop.propagate(pot, bench_torch.AS60_DT, nt,
                                    check_energy=False)
    if not (np.isfinite(cauto).all() and np.isfinite(kic).all()):
        raise FloatingPointError("C(t) or k~ic(t) is not finite")
    wall = timer.phases["scan"]
    line = {
        "bench": "pod_flagship", "propagator": propagator,
        "nchips": nchips, "ntraj": prop.ntraj, "nt": nt,
        "traj_steps_per_s": round(prop.ntraj * nt / wall, 1),
        "traj_steps_per_s_per_chip": round(prop.ntraj * nt / wall / nchips,
                                           1),
        "wall_s": round(wall, 3),
        "devices": [f"{device.type}:{r}" for r in range(min(nchips, 4))]
        + (["..."] if nchips > 4 else []),
        "device": bench_torch.device_line(device),
        "warmup_s": round(timer.phases["warmup"], 3)}
    return line, (cauto, kic)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ntraj-per-chip", type=int, default=524288)
    ap.add_argument("--nt", type=int, default=500)
    ap.add_argument("--propagator", default="HK", choices=["HK", "WM"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--coordinator", default="",
                    help="rank 0's host:port, or a torch.distributed URL "
                         "(file://...); none: a single process")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)
    device = bench_torch.resolve_device(args.device)
    group = (init_group(args.coordinator, args.num_processes,
                        args.process_id, device)
             if args.coordinator else None)
    try:
        line, _ = run(group, device, args.propagator, args.ntraj_per_chip,
                      args.nt)
        if group is None or group.rank == 0:
            print(json.dumps(line), flush=True)
    finally:
        destroy_group(group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
