#!/usr/bin/env python3
# coding: utf-8
"""Smoke test of the PyTorch/CUDA port (semiclassical_tpu_torch) on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It needs one card, builds the port's CUDA kernels from `csrc/`, and exits
non-zero at the first fault. Phases, one line each:

1. device  — the card's name and power limit (nvidia-smi), the kernel build
             time;
2. K1      — the batched-determinant kernel against its plain PyTorch
             version and against torch.linalg.det as the oracle, at the
             main path's shape (10000, 6, 6) in complex128 and complex64 and
             at (4096, 45, 45) and (4096, 60, 60) in complex128, on
             well-conditioned inputs I + 0.3 noise / sqrt(r); then the
             kernel's and the plain version's median times at
             (10000, 6, 6) complex128 (CUDA events);
3. methylium — examples/methylium_AH at its own size (50,000 trajectories
             x 2000 steps, batches of 10,000) through the port's
             `cli.main(["dynamics", ...])` and `cli.main(["rates", ...])`
             on cuda: finite correlations, |C(0) - 1| < 1e-3, the rate at
             its maximum within 3% of
             tests/data/methylium_reference_rate_10k.npz, and the kernel
             launched on every step of the run;
4. the kernels' JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
EXAMPLE = ROOT / "examples" / "methylium_AH" / "semi.json"
REFERENCE_RATE = ROOT / "tests" / "data" / "methylium_reference_rate_10k.npz"
RATE_GATE = 0.03
SEED = 1234

# (n, r, dtype name, limit kernel-vs-plain, limit vs the c128 oracle)
K1_CASES = [
    (10000, 6, "complex128", 1e-12, 1e-10),
    (10000, 6, "complex64", 1e-5, 1e-4),
    (4096, 45, "complex128", 1e-12, 1e-10),
    (4096, 60, "complex128", 1e-12, 1e-10),
]


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def max_rel(x, ref):
    import torch
    x = x.to(torch.complex128)
    ref = ref.to(torch.complex128)
    return float(((x - ref).abs() / ref.abs()).max())


def well_conditioned(n, r, dtype, generator):
    import torch
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    noise = torch.complex(
        torch.randn(n, r, r, generator=generator, device="cuda", dtype=rdtype),
        torch.randn(n, r, r, generator=generator, device="cuda", dtype=rdtype))
    return (torch.eye(r, dtype=dtype, device="cuda")
            + 0.3 * noise / r**0.5).contiguous()


def median_ms(fn, A, loops=10, calls=20):
    """Median over `loops` CUDA-event windows of `calls` back-to-back calls,
    per call, after a warm-up."""
    import torch
    for _ in range(5):
        fn(A)
    samples = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(A)
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / calls)
    return samples


def k1_phase(det):
    import numpy as np
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    main_abs_err = None
    for n, r, dname, lim_kp, lim_oracle in K1_CASES:
        dtype = getattr(torch, dname)
        A = well_conditioned(n, r, dtype, g)
        k = det.batched_det(A)
        p = det.batched_det_lu_plain(A)
        oracle = torch.linalg.det(A.to(torch.complex128))
        torch.cuda.synchronize()
        e_kp, e_ko, e_po = max_rel(k, p), max_rel(k, oracle), max_rel(p, oracle)
        if (n, r, dname) == (10000, 6, "complex128"):
            main_abs_err = float((k - p).abs().max())
        print(f"K1 ({n}, {r}, {r}) {dname}: max rel err kernel-plain {e_kp:.3e} "
              f"(limit {lim_kp:g}), kernel-oracle {e_ko:.3e}, plain-oracle "
              f"{e_po:.3e} (limit {lim_oracle:g})", flush=True)
        check(bool(torch.isfinite(k).all()), f"K1 non-finite at r={r} {dname}")
        check(e_kp <= lim_kp, f"K1 kernel vs plain {e_kp} > {lim_kp}")
        check(e_ko <= lim_oracle and e_po <= lim_oracle,
              f"K1 vs oracle {e_ko}, {e_po} > {lim_oracle}")

    A = well_conditioned(10000, 6, torch.complex128, g)
    # in turns: plain, kernel, kernel, plain
    t_plain = median_ms(det.batched_det_lu_plain, A)
    t_kernel = median_ms(det.batched_det, A)
    t_kernel += median_ms(det.batched_det, A)
    t_plain += median_ms(det.batched_det_lu_plain, A)
    ms, plain_ms = float(np.median(t_kernel)), float(np.median(t_plain))
    print(f"K1 time at (10000, 6, 6) complex128: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms per call (median of {len(t_kernel)} CUDA-event "
          "windows of 20 calls)", flush=True)
    return main_abs_err, ms, plain_ms


def methylium_phase(cli, det, smi):
    import numpy as np
    import torch

    with open(EXAMPLE) as f:
        config = json.load(f)
    nsteps = nrep = ntraj = None
    with tempfile.TemporaryDirectory() as tmp:
        npz = str(pathlib.Path(tmp) / "correlations.npz")
        for task in config["semi"]:
            if task["task"] == "dynamics":
                for key in ("ground", "excited", "coupling"):
                    task["potential"][key] = str(
                        (EXAMPLE.parent / task["potential"][key]).resolve())
                task["manual_seed"] = SEED
                task["results"]["correlations"] = npz
                nsteps = task["num_steps"]
                ntraj = task["num_trajectories"]
                nrep = ntraj // task["batch_size"]
            else:
                task["correlations"] = npz
                task["rates"] = npz
        cfg = str(pathlib.Path(tmp) / "semi.json")
        with open(cfg, "w") as f:
            json.dump(config, f, indent=1)

        det.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(["dynamics", cfg, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = det.LAUNCHES
        check(rc == 0, f"dynamics returned {rc}")
        check(cli.main(["rates", cfg]) == 0, "rates failed")
        data = dict(np.load(npz))

    ref = np.load(REFERENCE_RATE)
    cauto, kic = data["autocorrelation"], data["ic_correlation"]
    check(cauto.shape == (nsteps,) and kic.shape == (nsteps,),
          f"correlation shapes {cauto.shape}, {kic.shape}")
    check(bool(np.isfinite(cauto).all() and np.isfinite(kic).all()),
          "non-finite correlations")
    c0_dev = abs(cauto[0] - 1.0)
    check(c0_dev < 1e-3, f"|C(0) - 1| = {c0_dev}")
    check(int(data["trajectories"]) == ntraj,
          f"accumulated {data['trajectories']} trajectories")
    check(data["ic_rate"].shape == ref["ic_rate"].shape
          and np.allclose(data["energies"], ref["energies"], rtol=1e-3),
          "rate energy grid differs from the reference's")
    imax = int(np.argmax(ref["ic_rate"]))
    rel = abs(ref["ic_rate"][imax] - data["ic_rate"][imax]) / abs(
        ref["ic_rate"][imax])
    check(launches >= nsteps * nrep,
          f"K1 launched {launches} times for {nsteps} x {nrep} steps")
    rate = ntraj * nsteps / wall
    print(f"methylium {ntraj} x {nsteps} steps ({nrep} batches): dynamics "
          f"command {wall:.3f} s wall, {rate:.0f} traj-steps/s [{smi}]; "
          f"|C(0) - 1| = {c0_dev:.2e}; rate at max {data['ic_rate'][imax]:.6e} "
          f"vs reference {ref['ic_rate'][imax]:.6e}: rel dev {rel:.4f} "
          f"(gate {RATE_GATE}); K1 launches {launches}", flush=True)
    check(rel < RATE_GATE, f"rate-at-maximum deviation {rel:.4f} >= 3%")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli
    from semiclassical_tpu_torch.ops import _build, det

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.3f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)
    for line in _build.build_log().splitlines():
        if "Used" in line:
            print(f"build: {line.strip()}", flush=True)

    abs_err, ms, plain_ms = k1_phase(det)
    launches = methylium_phase(cli, det, smi)

    print(json.dumps({"kernels": [{
        "name": "batched_det_lu",
        "route": "cuda",
        "source": "semiclassical_tpu_torch/csrc/det_lu.cu",
        "replaces": "semiclassical_tpu/ops/det_kernel.py:257",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
