#!/usr/bin/env python3
# coding: utf-8
"""Smoke test of the PyTorch/CUDA port (semiclassical_tpu_torch) on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It needs one card, builds the port's CUDA kernels from `csrc/`, and exits
non-zero at the first fault. Phases, one line each:

1. device  — the card's name and power limit (nvidia-smi), the kernel build
             time and ptxas' register / shared-memory report;
2. K1      — the batched-determinant kernel against its plain PyTorch
             version and against torch.linalg.det as the oracle, at the
             main path's shape (10000, 6, 6) in complex128 and complex64 and
             at (4096, 45, 45) and (4096, 60, 60) in complex128, on
             well-conditioned inputs I + 0.3 noise / sqrt(r); then the
             kernel's and the plain version's median times at
             (10000, 6, 6) complex128 (CUDA events);
3. K2      — the Gauss-Jordan det + solve kernel against its plain version
             and against torch.linalg.det / solve, at the WM path's shapes
             (10000, 6, 6 | 12), (10000, 6, 6 | 6), (10000, 6, 6 | 5) in
             complex128 and complex64 and at the flagship leaf
             (2048, 60, 60 | 120) in complex128; times at (10000, 6, 6 | 12)
             complex128;
4. K3      — the Gauss-Jordan det + inverse kernel the same way against
             torch.linalg.det / inv at (10000, 12, 12) and (10000, 6, 6) in
             complex128 and complex64 and at (2048, 60, 60) in complex128;
             times at (10000, 12, 12) complex128;
5. HK methylium — examples/methylium_AH at its own size (50,000
             trajectories x 2000 steps, batches of 10,000) through the
             port's `cli.main(["dynamics", ...])` and
             `cli.main(["rates", ...])` on cuda: finite correlations,
             |C(0) - 1| < 1e-3, the rate at its maximum within 3% of
             tests/data/methylium_reference_rate_10k.npz, and K1 launched on
             every step of the run;
6. WM methylium — the same example in memory with propagator "WM" and
             cell_width 1e4 at the same seed and size: the same gates, the
             rate at its maximum within 1e-3 of the HK phase's own, and K1
             launched on every step, K2 three times per step, K3 twice per
             batch;
7. the kernels' JSON line, then the result line
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
WM_HK_GATE = 1e-3
SEED = 1234
CELL_WIDTH = 10000.0

# (n, r, dtype name, limit kernel-vs-plain, limit vs the c128 oracle)
K1_CASES = [
    (10000, 6, "complex128", 1e-12, 1e-10),
    (10000, 6, "complex64", 1e-5, 1e-4),
    (4096, 45, "complex128", 1e-12, 1e-10),
    (4096, 60, "complex128", 1e-12, 1e-10),
]
# (n, m, k, dtype name, limit kernel-vs-plain, limit vs the c128 oracle)
K2_CASES = [
    (10000, 6, 12, "complex128", 1e-12, 1e-10),
    (10000, 6, 12, "complex64", 1e-5, 1e-4),
    (10000, 6, 6, "complex128", 1e-12, 1e-10),
    (10000, 6, 6, "complex64", 1e-5, 1e-4),
    (10000, 6, 5, "complex128", 1e-12, 1e-10),
    (10000, 6, 5, "complex64", 1e-5, 1e-4),
    (2048, 60, 120, "complex128", 1e-12, 1e-10),
]
# (n, m, dtype name, limit kernel-vs-plain, limit vs the c128 oracle)
K3_CASES = [
    (10000, 12, "complex128", 1e-12, 1e-10),
    (10000, 12, "complex64", 1e-5, 1e-4),
    (10000, 6, "complex128", 1e-12, 1e-10),
    (10000, 6, "complex64", 1e-5, 1e-4),
    (2048, 60, "complex128", 1e-12, 1e-10),
]


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def max_rel(x, ref):
    """Largest relative error over a batch of numbers."""
    import torch
    x = x.to(torch.complex128)
    ref = ref.to(torch.complex128)
    return float(((x - ref).abs() / ref.abs()).max())


def max_rel_mat(x, ref):
    """Largest error of a batch of matrices, each relative to its own
    largest entry."""
    import torch
    x = x.to(torch.complex128)
    ref = ref.to(torch.complex128)
    return float(((x - ref).abs().amax(dim=(1, 2))
                  / ref.abs().amax(dim=(1, 2))).max())


def gaussian(shape, dtype, generator):
    import torch
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.complex(
        torch.randn(shape, generator=generator, device="cuda", dtype=rdtype),
        torch.randn(shape, generator=generator, device="cuda", dtype=rdtype))


def well_conditioned(n, r, dtype, generator):
    import torch
    return (torch.eye(r, dtype=dtype, device="cuda")
            + 0.3 * gaussian((n, r, r), dtype, generator) / r**0.5).contiguous()


def median_ms(fn, *args, loops=10, calls=20):
    """Per-call times over `loops` CUDA-event windows of `calls`
    back-to-back calls, after a warm-up."""
    import torch
    for _ in range(5):
        fn(*args)
    samples = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(*args)
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / calls)
    return samples


def in_turns(kernel, plain, *args):
    """Median per-call ms of the kernel and of the plain version, timed in
    turns: plain, kernel, kernel, plain."""
    import numpy as np
    t_plain = median_ms(plain, *args)
    t_kernel = median_ms(kernel, *args)
    t_kernel += median_ms(kernel, *args)
    t_plain += median_ms(plain, *args)
    return float(np.median(t_kernel)), float(np.median(t_plain)), len(t_kernel)


def k1_phase(det):
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
    ms, plain_ms, count = in_turns(det.batched_det, det.batched_det_lu_plain, A)
    print(f"K1 time at (10000, 6, 6) complex128: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms per call (median of {count} CUDA-event "
          "windows of 20 calls)", flush=True)
    return main_abs_err, ms, plain_ms


def k2_phase(gj):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    main_abs_err = None
    for n, m, k, dname, lim_kp, lim_oracle in K2_CASES:
        dtype = getattr(torch, dname)
        A = well_conditioned(n, m, dtype, g)
        B = gaussian((n, m, k), dtype, g)
        det_k, sol_k = gj.batched_det_solve_gj(A, B)
        det_p, sol_p = gj.batched_det_solve_gj_plain(A, B)
        A128, B128 = A.to(torch.complex128), B.to(torch.complex128)
        det_o = torch.linalg.det(A128)
        sol_o = torch.linalg.solve(A128, B128)
        torch.cuda.synchronize()
        e_kp = max(max_rel(det_k, det_p), max_rel_mat(sol_k, sol_p))
        e_ko = max(max_rel(det_k, det_o), max_rel_mat(sol_k, sol_o))
        e_po = max(max_rel(det_p, det_o), max_rel_mat(sol_p, sol_o))
        if (n, m, k, dname) == (10000, 6, 12, "complex128"):
            main_abs_err = max(float((det_k - det_p).abs().max()),
                               float((sol_k - sol_p).abs().max()))
        print(f"K2 ({n}, {m}, {m} | {k}) {dname}: max rel err kernel-plain "
              f"{e_kp:.3e} (limit {lim_kp:g}), kernel-oracle {e_ko:.3e}, "
              f"plain-oracle {e_po:.3e} (limit {lim_oracle:g})", flush=True)
        check(bool(torch.isfinite(det_k).all() and torch.isfinite(sol_k).all()),
              f"K2 non-finite at m={m} k={k} {dname}")
        check(e_kp <= lim_kp, f"K2 kernel vs plain {e_kp} > {lim_kp}")
        check(e_ko <= lim_oracle and e_po <= lim_oracle,
              f"K2 vs oracle {e_ko}, {e_po} > {lim_oracle}")

    A = well_conditioned(10000, 6, torch.complex128, g)
    B = gaussian((10000, 6, 12), torch.complex128, g)
    ms, plain_ms, count = in_turns(gj.batched_det_solve_gj,
                                   gj.batched_det_solve_gj_plain, A, B)
    print(f"K2 time at (10000, 6, 6 | 12) complex128: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per call (median of {count} CUDA-event "
          "windows of 20 calls)", flush=True)
    return main_abs_err, ms, plain_ms


def k3_phase(gj):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)
    main_abs_err = None
    for n, m, dname, lim_kp, lim_oracle in K3_CASES:
        dtype = getattr(torch, dname)
        A = well_conditioned(n, m, dtype, g)
        det_k, inv_k = gj.batched_det_inv_gj(A)
        det_p, inv_p = gj.batched_det_inv_gj_plain(A)
        A128 = A.to(torch.complex128)
        det_o, inv_o = torch.linalg.det(A128), torch.linalg.inv(A128)
        torch.cuda.synchronize()
        e_kp = max(max_rel(det_k, det_p), max_rel_mat(inv_k, inv_p))
        e_ko = max(max_rel(det_k, det_o), max_rel_mat(inv_k, inv_o))
        e_po = max(max_rel(det_p, det_o), max_rel_mat(inv_p, inv_o))
        if (n, m, dname) == (10000, 12, "complex128"):
            main_abs_err = max(float((det_k - det_p).abs().max()),
                               float((inv_k - inv_p).abs().max()))
        print(f"K3 ({n}, {m}, {m}) {dname}: max rel err kernel-plain "
              f"{e_kp:.3e} (limit {lim_kp:g}), kernel-oracle {e_ko:.3e}, "
              f"plain-oracle {e_po:.3e} (limit {lim_oracle:g})", flush=True)
        check(bool(torch.isfinite(det_k).all() and torch.isfinite(inv_k).all()),
              f"K3 non-finite at m={m} {dname}")
        check(e_kp <= lim_kp, f"K3 kernel vs plain {e_kp} > {lim_kp}")
        check(e_ko <= lim_oracle and e_po <= lim_oracle,
              f"K3 vs oracle {e_ko}, {e_po} > {lim_oracle}")

    A = well_conditioned(10000, 12, torch.complex128, g)
    ms, plain_ms, count = in_turns(gj.batched_det_inv_gj,
                                   gj.batched_det_inv_gj_plain, A)
    print(f"K3 time at (10000, 12, 12) complex128: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms per call (median of {count} CUDA-event "
          "windows of 20 calls)", flush=True)
    return main_abs_err, ms, plain_ms


def methylium_run(cli, det, gj, smi, label, **task_keys):
    """examples/methylium_AH at its own size through the port's CLI on
    cuda, with `task_keys` set on the dynamics task. Returns (the rates
    npz as a dict, the kernels' launches during the dynamics command)."""
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
                task.update(task_keys, manual_seed=SEED)
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
        for name in gj.LAUNCHES:
            gj.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        rc = cli.main(["dynamics", cfg, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": det.LAUNCHES, "K2": gj.LAUNCHES["det_solve"],
                    "K3": gj.LAUNCHES["det_inv"]}
        check(rc == 0, f"{label} dynamics returned {rc}")
        check(cli.main(["rates", cfg]) == 0, f"{label} rates failed")
        data = dict(np.load(npz))

    ref = np.load(REFERENCE_RATE)
    cauto, kic = data["autocorrelation"], data["ic_correlation"]
    check(cauto.shape == (nsteps,) and kic.shape == (nsteps,),
          f"{label} correlation shapes {cauto.shape}, {kic.shape}")
    check(bool(np.isfinite(cauto).all() and np.isfinite(kic).all()),
          f"{label} non-finite correlations")
    c0_dev = abs(cauto[0] - 1.0)
    check(c0_dev < 1e-3, f"{label} |C(0) - 1| = {c0_dev}")
    check(int(data["trajectories"]) == ntraj,
          f"{label} accumulated {data['trajectories']} trajectories")
    check(data["ic_rate"].shape == ref["ic_rate"].shape
          and np.allclose(data["energies"], ref["energies"], rtol=1e-3),
          f"{label} rate energy grid differs from the reference's")
    imax = int(np.argmax(ref["ic_rate"]))
    rel = abs(ref["ic_rate"][imax] - data["ic_rate"][imax]) / abs(
        ref["ic_rate"][imax])
    check(launches["K1"] >= nsteps * nrep,
          f"{label}: K1 launched {launches['K1']} times for {nsteps} x "
          f"{nrep} steps")
    rate = ntraj * nsteps / wall
    print(f"{label} methylium {ntraj} x {nsteps} steps ({nrep} batches): "
          f"dynamics command {wall:.3f} s wall, {rate:.0f} traj-steps/s "
          f"[{smi}]; |C(0) - 1| = {c0_dev:.2e}; rate at max "
          f"{data['ic_rate'][imax]:.6e} vs reference {ref['ic_rate'][imax]:.6e}:"
          f" rel dev {rel:.4f} (gate {RATE_GATE}); launches "
          f"{json.dumps(launches)}", flush=True)
    check(rel < RATE_GATE, f"{label} rate-at-maximum deviation {rel:.4f} >= 3%")
    data.update(imax=imax, nsteps=nsteps, nrep=nrep)
    return data, launches


def wm_phase(cli, det, gj, smi, hk):
    """The WM path at the HK phase's seed and size, held against it."""
    wm, launches = methylium_run(cli, det, gj, smi, "WM", propagator="WM",
                                 cell_width=CELL_WIDTH)
    imax, nsteps, nrep = hk["imax"], hk["nsteps"], hk["nrep"]
    rel = abs(wm["ic_rate"][imax] - hk["ic_rate"][imax]) / abs(
        hk["ic_rate"][imax])
    print(f"WM vs HK at seed {SEED}: rate at max {wm['ic_rate'][imax]:.6e} vs "
          f"{hk['ic_rate'][imax]:.6e}, rel dev {rel:.3e} (gate {WM_HK_GATE:g})",
          flush=True)
    check(str(wm["propagator"]) == "WM", f"npz propagator {wm['propagator']}")
    check(rel < WM_HK_GATE, f"WM vs HK rate deviation {rel:.3e} >= {WM_HK_GATE}")
    check(launches["K2"] >= 3 * nsteps * nrep,
          f"WM: K2 launched {launches['K2']} times for {nsteps} x {nrep} steps")
    check(launches["K3"] >= 2 * nrep,
          f"WM: K3 launched {launches['K3']} times for {nrep} batches")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli
    from semiclassical_tpu_torch.ops import _build, det, gj

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
        if "Used" in line or "Compiling entry" in line:
            print(f"build: {line.strip()}", flush=True)

    k1 = k1_phase(det)
    k2 = k2_phase(gj)
    k3 = k3_phase(gj)
    hk, hk_launches = methylium_run(cli, det, gj, smi, "HK")
    wm_launches = wm_phase(cli, det, gj, smi, hk)

    def entry(name, source, replaces, launches, measured):
        abs_err, ms, plain_ms = measured
        return {"name": name, "route": "cuda",
                "source": f"semiclassical_tpu_torch/csrc/{source}",
                "replaces": f"semiclassical_tpu/ops/det_kernel.py:{replaces}",
                "launches": launches, "max_abs_err": abs_err, "ms": ms,
                "plain_ms": plain_ms}

    print(json.dumps({"kernels": [
        entry("batched_det_lu", "det_lu.cu", 257, hk_launches["K1"], k1),
        entry("batched_det_solve_gj", "gj_det.cu", 460, wm_launches["K2"], k2),
        entry("batched_det_inv_gj", "gj_det.cu", 532, wm_launches["K3"], k3),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
