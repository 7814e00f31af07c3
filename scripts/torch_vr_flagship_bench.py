#!/usr/bin/env python3
# coding: utf-8
"""Variance reduction on the 60-mode AS flagship with the PyTorch/CUDA port
(semiclassical_tpu_torch), on one NVIDIA GPU: the twin of the JAX
package's `scripts/vr_flagship_bench.py`.

    python3 scripts/torch_vr_flagship_bench.py --ntraj 65536 --nt 100 --keys 6
    python3 scripts/torch_vr_flagship_bench.py --device cpu --ntraj 64 \\
        --nt 12 --keys 2

For each sampling method: `keys` independent realizations (a new HK
propagator each, its batch drawn from a `torch.Generator` seeded 1000 +
key; the same physics), C(t) and k~ic(t) of each, the across-key variance
(mean over steps) and the sampling and scan walls. The model is
`bench_torch.as60_model` (default_rng(42), d = 60, the JAX script's),
comp32 trajectories with float32 algebra, dt 0.25, the wavepacket at rest
at dQ with width diag(omega).

Prints one JSON line per method with the JAX script's keys; "device" holds
the card's name and power limit (nvidia-smi; "cpu" on the CPU), and
"graph" the time loop's counters over the method's batches
(`propagation.graph.STATS`: replays, captures with their capture plus
instantiate seconds, eager blocks). Every batch of every method runs
through one time loop, which the process keeps: on the card the first
batch runs each block length once eagerly and captures it, and every
later batch only replays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

DT = 0.25
ENERGY0 = 0.0
KEY_OFFSET = 1000


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ntraj=65536, nt=100, keys=6, methods=("pseudo", "sobol",
                                               "antithetic"),
        device="cuda", on_batch=None):
    """The study: [(JSON line, (C(t) (keys, nt), k~ic(t) (keys, nt)))] per
    method. `on_batch(method, key, propagator)`, if given, sees each batch
    after its scan."""
    from semiclassical_tpu_torch.potentials import MorsePotential
    from semiclassical_tpu_torch.propagation import HermanKlukPropagator, graph

    device = torch.device(device)
    omega, _, nac, chi, dQ = bench_torch.as60_model()
    dtype, traj_dtype = bench_torch.HK_MODES["comp32"]
    pot = MorsePotential.create(omega, chi, nac, device=device, dtype=dtype)
    Gamma = np.diag(omega)
    where = bench_torch.device_line(device)
    out = []
    for method in methods:
        cs, ks = [], []
        t_sample = t_scan = 0.0
        stats = dict(graph.STATS)
        for key in range(keys):
            prop = HermanKlukPropagator(Gamma, Gamma, device, dtype=dtype,
                                        traj_dtype=traj_dtype)
            generator = torch.Generator(device=device).manual_seed(
                KEY_OFFSET + key)
            t0 = time.perf_counter()
            prop.initial_conditions(dQ, np.zeros_like(dQ), Gamma, pot,
                                    ntraj=ntraj, generator=generator,
                                    sampling_method=method)
            _sync(device)
            t_sample += time.perf_counter() - t0
            t0 = time.perf_counter()
            c, k = prop.propagate(pot, DT, nt, energy0_es=ENERGY0,
                                  check_energy=False)
            t_scan += time.perf_counter() - t0
            cs.append(c)
            ks.append(k)
            if on_batch is not None:
                on_batch(method, key, prop)
        cs, ks = np.stack(cs), np.stack(ks)
        loop = {k: graph.STATS[k] - stats[k] for k in stats}
        loop["capture_s"] = round(loop["capture_s"], 3)
        out.append(({
            "bench": "vr_flagship", "method": method,
            "ntraj": ntraj, "nt": nt, "keys": keys,
            "var_C": float(np.mean(np.var(cs, axis=0))),
            "var_kic": float(np.mean(np.var(ks, axis=0))),
            "mean_absC_final": float(np.mean(np.abs(cs[:, -1]))),
            "sample_s_per_rep": round(t_sample / keys, 3),
            "scan_s_per_rep": round(t_scan / keys, 3),
            "device": where,
            "graph": loop,
        }, (cs, ks)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ntraj", type=int, default=65536)
    ap.add_argument("--nt", type=int, default=100)
    ap.add_argument("--keys", type=int, default=6)
    ap.add_argument("--methods", default="pseudo,sobol,antithetic")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = bench_torch.resolve_device(args.device)
    for line, _ in run(args.ntraj, args.nt, args.keys,
                       args.methods.split(","), device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
