#!/usr/bin/env python3
# coding: utf-8
"""Smoke test of the PyTorch/CUDA port (semiclassical_tpu_torch) on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It needs one card, builds the port's CUDA kernels from `csrc/`, and exits
non-zero at the first fault. Each kernel is timed in turns against its plain
version and against the one PyTorch call that computes the same function
(where there is one), beside its bound: the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its flops over the
FP64 peak of 34 TFLOP/s (NVIDIA's H100 SXM data sheet). Phases, one line
each, each with its wall time:

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
4b. K5     — the fused separable WM kernel against its plain version on
             the 60-mode AS example's WM state after 10 steps, at
             (98304, 60), (8192, 60) and (1000, 5) in float64 and (98304,
             60) in float32, every output row within 1e-12 (float64) / 1e-5
             (float32) of its own largest entry; times at (98304, 60)
             float64;
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
7. HK AS   — examples/as_model/semi.json (60 modes, AS_model.dat written
             by make_model.py into a temporary directory) at its own size,
             98,304 trajectories x 2000 steps, without its error bars and
             spectrum task, through `dynamics` + `rates` on cuda: finite
             correlations, |C(0) - 1| < 1e-3, 98,304 trajectories, the rate
             energy grid of examples/as_model/correlations_100k_reference.npz
             and the rate at its maximum within 3% of that file's;
8. WM AS   — semi_wm.json (cell width 1e4) at the same seed and size: the
             same gates, the rate at its maximum within 4.1e-4 of the HK AS
             run's (10x the JAX package's WM - HK gap at the same draws,
             scripts/as_wm_hk_gap.py), and K5 launched on every step;
9. the kernels' JSON line, then the result line
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
AS_EXAMPLE = ROOT / "examples" / "as_model"
AS_REFERENCE = AS_EXAMPLE / "correlations_100k_reference.npz"
RATE_GATE = 0.03
WM_HK_GATE = 1e-3
WM_HK_GATE_AS = 4.1e-4
SEED = 1234
CELL_WIDTH = 10000.0
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
# flops per (trajectory, mode) of K5, counted from csrc/wm_diag.cu
K5_FLOPS = 290

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
# (n, d, dtype name, limit kernel-vs-plain per output row)
K5_CASES = [
    (98304, 60, "float64", 1e-12),
    (8192, 60, "float64", 1e-12),
    (1000, 5, "float64", 1e-12),
    (98304, 60, "float32", 1e-5),
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


def in_turns(kernel, plain, library, *args):
    """Median per-call ms of the kernel, the plain version and the library
    call (None: not timed), timed in turns: plain, library, kernel, kernel,
    library, plain."""
    import numpy as np
    fns = {"plain": plain, "library": library, "kernel": kernel}
    t = {name: [] for name in fns}
    for name in ("plain", "library", "kernel", "kernel", "library", "plain"):
        if fns[name] is not None:
            t[name] += median_ms(fns[name], *args)
    med = {name: float(np.median(v)) if v else None for name, v in t.items()}
    return {"ms": med["kernel"], "plain_ms": med["plain"],
            "library_ms": med["library"], "windows": len(t["kernel"])}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the flops over the FP64 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def timing_line(label, shape, timed, bound_ms, bound_by, library):
    return (f"{label} time at {shape}: kernel {timed['ms']:.4f} ms, plain "
            f"{timed['plain_ms']:.4f} ms, library ({library}) "
            + (f"{timed['library_ms']:.4f} ms" if timed["library_ms"]
               is not None else "none")
            + f" per call (median of {timed['windows']} CUDA-event windows "
            f"of 20 calls); bound {bound_ms:.4f} ms by {bound_by}, "
            f"{100 * bound_ms / timed['ms']:.1f}% of it reached")


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

    n, r = 10000, 6
    A = well_conditioned(n, r, torch.complex128, g)
    timed = in_turns(det.batched_det, det.batched_det_lu_plain,
                     torch.linalg.det, A)
    # LU: per pivot a reciprocal, r-k-1 column scalings and the (r-k-1)^2
    # trailing update, complex (6 and 8 flops)
    flops = n * sum(8 * (r - k - 1) ** 2 + 6 * (r - k - 1) + 12
                    for k in range(r))
    b = bound(n * (r * r + 1) * 16, flops)
    print(timing_line("K1", "(10000, 6, 6) complex128", timed, *b,
                      "torch.linalg.det"), flush=True)
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


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

    n, m, k = 10000, 6, 12
    A = well_conditioned(n, m, torch.complex128, g)
    B = gaussian((n, m, k), torch.complex128, g)
    timed = in_turns(gj.batched_det_solve_gj, gj.batched_det_solve_gj_plain,
                     lambda A, B: (torch.linalg.solve(A, B),
                                   torch.linalg.det(A)), A, B)
    # Gauss-Jordan on [A | B]: per pivot a reciprocal, the live columns of
    # the pivot row scaled and those of the m - 1 other rows updated
    flops = n * sum(6 * (m + k - kp - 1) + 8 * (m - 1) * (m + k - kp - 1)
                    + 12 for kp in range(m))
    b = bound(n * (m * m + 2 * m * k + 1) * 16, flops)
    print(timing_line("K2", "(10000, 6, 6 | 12) complex128", timed, *b,
                      "torch.linalg.solve + det"), flush=True)
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


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

    n, m = 10000, 12
    A = well_conditioned(n, m, torch.complex128, g)
    timed = in_turns(gj.batched_det_inv_gj, gj.batched_det_inv_gj_plain,
                     lambda A: (torch.linalg.inv_ex(A), torch.linalg.det(A)),
                     A)
    # in-place Gauss-Jordan: per pivot the row scaled, m - 1 rows updated
    flops = n * sum(6 * m + 8 * (m - 1) * m + 12 for _ in range(m))
    b = bound(n * (2 * m * m + 1) * 16, flops)
    print(timing_line("K3", "(10000, 12, 12) complex128", timed, *b,
                      "torch.linalg.inv_ex + det"), flush=True)
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


def reset_counts(ops):
    """Set every kernel's launch count to 0."""
    ops["det"].LAUNCHES = 0
    for name in ops["gj"].LAUNCHES:
        ops["gj"].LAUNCHES[name] = 0
    ops["wm_diag"].LAUNCHES = 0


def read_counts(ops):
    return {"K1": ops["det"].LAUNCHES, "K2": ops["gj"].LAUNCHES["det_solve"],
            "K3": ops["gj"].LAUNCHES["det_inv"], "K5": ops["wm_diag"].LAUNCHES}


def run_path(cli, ops, config, dynamics_keys, tmp):
    """Run `config`'s dynamics task (updated with `dynamics_keys`) and its
    rates task through the port's CLI on cuda, writing into `tmp`; every
    launch count is set to 0 just before the dynamics command and read just
    after. Returns (the rates npz as a dict, the launches, the dynamics
    task, the dynamics command's wall seconds)."""
    import numpy as np
    import torch

    npz = str(pathlib.Path(tmp) / "correlations.npz")
    tasks = []
    for task in config["semi"]:
        if task["task"] == "dynamics":
            task.update(dynamics_keys, manual_seed=SEED)
            task.pop("error_bars", None)
            task["results"]["correlations"] = npz
            dynamics = task
        elif task["task"] == "rates":
            task.update(correlations=npz, rates=npz)
        else:
            continue        # the spectrum subcommand is not ported
        tasks.append(task)
    cfg = str(pathlib.Path(tmp) / "semi.json")
    with open(cfg, "w") as f:
        json.dump({"semi": tasks}, f, indent=1)

    reset_counts(ops)
    t0 = time.perf_counter()
    rc = cli.main(["dynamics", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(ops)
    check(rc == 0, f"dynamics returned {rc}")
    check(cli.main(["rates", cfg]) == 0, "rates failed")
    return dict(np.load(npz)), launches, dynamics, wall


def gate_rates(label, data, ref_file, ntraj, nsteps, energy_rtol):
    """The gates every path shares: correlation shapes, finiteness, C(0),
    the accumulated trajectories, the reference's energy grid and the rate
    at the reference's maximum within RATE_GATE. Returns the index of that
    maximum."""
    import numpy as np

    ref = np.load(ref_file)
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
          and np.allclose(data["energies"], ref["energies"],
                          rtol=energy_rtol),
          f"{label} rate energy grid differs from the reference's")
    imax = int(np.argmax(ref["ic_rate"]))
    rel = abs(ref["ic_rate"][imax] - data["ic_rate"][imax]) / abs(
        ref["ic_rate"][imax])
    print(f"{label}: rate at max {data['ic_rate'][imax]:.6e} vs reference "
          f"{ref['ic_rate'][imax]:.6e}: rel dev {rel:.4f} (gate {RATE_GATE});"
          f" |C(0) - 1| = {c0_dev:.2e}", flush=True)
    check(rel < RATE_GATE, f"{label} rate-at-maximum deviation {rel:.4f} "
          f">= {RATE_GATE}")
    return imax


def methylium_run(cli, ops, smi, label, **task_keys):
    """examples/methylium_AH at its own size through the port's CLI on
    cuda, with `task_keys` set on the dynamics task. Returns (the rates
    npz as a dict, the kernels' launches during the dynamics command)."""
    with open(EXAMPLE) as f:
        config = json.load(f)
    for task in config["semi"]:
        if task["task"] == "dynamics":
            for key in ("ground", "excited", "coupling"):
                task["potential"][key] = str(
                    (EXAMPLE.parent / task["potential"][key]).resolve())
    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall = run_path(cli, ops, config, task_keys,
                                              tmp)
    nsteps, ntraj = task["num_steps"], task["num_trajectories"]
    nrep = ntraj // task["batch_size"]
    print(f"{label} methylium {ntraj} x {nsteps} steps ({nrep} batches): "
          f"dynamics command {wall:.3f} s wall, "
          f"{ntraj * nsteps / wall:.0f} traj-steps/s [{smi}]; launches "
          f"{json.dumps(launches)}", flush=True)
    imax = gate_rates(f"{label} methylium", data, REFERENCE_RATE, ntraj,
                      nsteps, 1e-3)
    check(launches["K1"] >= nsteps * nrep,
          f"{label}: K1 launched {launches['K1']} times for {nsteps} x "
          f"{nrep} steps")
    data.update(imax=imax, nsteps=nsteps, nrep=nrep)
    return data, launches


def wm_vs_hk(label, wm, hk, gate):
    rel = abs(wm["ic_rate"][hk["imax"]] - hk["ic_rate"][hk["imax"]]) / abs(
        hk["ic_rate"][hk["imax"]])
    print(f"{label} WM vs HK at seed {SEED}: rate at max "
          f"{wm['ic_rate'][hk['imax']]:.6e} vs {hk['ic_rate'][hk['imax']]:.6e}"
          f", rel dev {rel:.3e} (gate {gate:g})", flush=True)
    check(str(wm["propagator"]) == "WM", f"npz propagator {wm['propagator']}")
    check(rel < gate, f"{label} WM vs HK rate deviation {rel:.3e} >= {gate}")


def wm_phase(cli, ops, smi, hk):
    """The WM path at the HK phase's seed and size, held against it."""
    wm, launches = methylium_run(cli, ops, smi, "WM", propagator="WM",
                                 cell_width=CELL_WIDTH)
    nsteps, nrep = hk["nsteps"], hk["nrep"]
    wm_vs_hk("methylium", wm, hk, WM_HK_GATE)
    check(launches["K2"] >= 3 * nsteps * nrep,
          f"WM: K2 launched {launches['K2']} times for {nsteps} x {nrep} steps")
    check(launches["K3"] >= 2 * nrep,
          f"WM: K3 launched {launches['K3']} times for {nrep} batches")
    return launches


def write_as_model(tmp):
    """examples/as_model/make_model.py's 60-mode model (rng seed 42, chi
    0.02) as AS_model.dat in `tmp`."""
    model = pathlib.Path(tmp) / "AS_model.dat"
    with open(model, "w") as f:
        subprocess.run([sys.executable, str(AS_EXAMPLE / "make_model.py")],
                       stdout=f, check=True, timeout=120)
    return str(model)


def as_run(cli, ops, smi, model, label, file):
    """examples/as_model/`file` at its own size through the port's CLI on
    cuda (error bars and the spectrum task dropped)."""
    with open(AS_EXAMPLE / file) as f:
        config = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall = run_path(
            cli, ops, config, {"potential": {"type": "anharmonic AS",
                                             "model_file": model}}, tmp)
    nsteps = task["num_steps"]
    nrep = max(task["num_trajectories"] // task["batch_size"], 1)
    ntraj = nrep * task["batch_size"]
    print(f"{label} AS {ntraj} x {nsteps} steps ({nrep} batch): dynamics "
          f"command {wall:.3f} s wall, {ntraj * nsteps / wall:.0f} "
          f"traj-steps/s [{smi}]; launches {json.dumps(launches)}",
          flush=True)
    # the committed reference predates the exact-spacing FFT energy axis
    # (2 t_max / (n_sym - 1)): its grid differs by one part in 4000 at
    # nt = 2000, as methylium's reference does
    imax = gate_rates(f"{label} AS", data, AS_REFERENCE, ntraj, nsteps, 1e-3)
    data.update(imax=imax, nsteps=nsteps, nrep=nrep)
    return data, launches


def k5_phase(cli, wm_diag, model):
    """K5 against its plain version on a WM state of the 60-mode AS
    example after 10 steps, and its times at (98304, 60) float64."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import (
        WaltonManolopoulosPropagator, wm)

    task = {"potential": {"type": "anharmonic AS", "model_file": model}}
    potential, q0, _, G, _, _ = cli._build_potential(task, "cuda")
    prop = WaltonManolopoulosPropagator(G, G, CELL_WIDTH, CELL_WIDTH,
                                        device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    prop.initial_conditions(q0, 0 * q0, G, potential, ntraj=98304,
                            generator=g)
    prop._run(potential, 0.005 / units.autime_to_fs, 10)
    planes, _ = wm.wm_diag_inputs(prop.params, prop.bc, prop.state,
                                  potential)
    pack = prop.params.diag_pack
    del prop

    def row_err(got, ref, dims):
        """Largest error per output row relative to the row's largest
        entry (absolute for a row of zeros: the p0 sums at p0 = 0)."""
        scale = ref.abs().amax(dim=dims)
        return float(((got - ref).abs().amax(dim=dims)
                      / torch.where(scale > 0, scale, 1.0)).max())

    main_abs_err = None
    for n, d, dname, lim in K5_CASES:
        dtype = getattr(torch, dname)
        args = [x[:n, :d].to(dtype).contiguous() for x in planes]
        cpack = pack[:, :d].to(dtype).contiguous()
        scal_k, det_k = wm_diag.wm_diag_derived(*args, cpack)
        scal_p, det_p = wm_diag.wm_diag_derived_plain(*args, cpack)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(scal_k).all()
                      and torch.isfinite(det_k).all())
        err = max(row_err(scal_k, scal_p, 0), row_err(det_k, det_p, (1, 2)))
        if (n, d, dname) == (98304, 60, "float64"):
            main_abs_err = max(float((scal_k - scal_p).abs().max()),
                               float((det_k - det_p).abs().max()))
        print(f"K5 ({n}, {d}) {dname}: max error kernel-plain per output "
              f"row, relative to the row's largest entry, {err:.3e} (limit "
              f"{lim:g})", flush=True)
        check(finite, f"K5 non-finite at ({n}, {d}) {dname}")
        check(err <= lim, f"K5 kernel vs plain {err} > {lim}")

    n, d = 98304, 60
    timed = in_turns(wm_diag.wm_diag_derived, wm_diag.wm_diag_derived_plain,
                     None, *planes, pack)
    b = bound((14 * n * d + wm_diag.N_SCAL * n + 17 * d) * 8,
              K5_FLOPS * n * d)
    print(timing_line("K5", "(98304, 60) float64", timed, *b, "none"),
          flush=True)
    del planes
    torch.cuda.empty_cache()
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli
    from semiclassical_tpu_torch.ops import _build, det, gj, wm_diag

    ops = {"det": det, "gj": gj, "wm_diag": wm_diag}
    t_start = time.perf_counter()
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
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print(f"build: {line.strip()}", flush=True)

    def phase(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s wall",
              flush=True)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        model = write_as_model(tmp)
        k1 = phase("K1", k1_phase, det)
        k2 = phase("K2", k2_phase, gj)
        k3 = phase("K3", k3_phase, gj)
        k5 = phase("K5", k5_phase, cli, wm_diag, model)
        hk, hk_launches = phase("HK methylium", methylium_run, cli, ops, smi,
                                "HK")
        wm_launches = phase("WM methylium", wm_phase, cli, ops, smi, hk)
        hk_as, _ = phase("HK AS", as_run, cli, ops, smi, model, "HK",
                         "semi.json")
        wm_as, wm_as_launches = phase("WM AS", as_run, cli, ops, smi, model,
                                      "WM", "semi_wm.json")
    wm_vs_hk("AS", wm_as, hk_as, WM_HK_GATE_AS)
    steps = wm_as["nsteps"] * wm_as["nrep"]
    check(wm_as_launches["K5"] >= steps,
          f"WM AS: K5 launched {wm_as_launches['K5']} times for {steps} "
          "steps")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def entry(name, source, replaces, launches, measured):
        keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")
        measured = dict(measured, launches=launches)
        return {"name": name, "route": "cuda",
                "source": f"semiclassical_tpu_torch/csrc/{source}",
                "replaces": f"semiclassical_tpu/ops/{replaces}",
                **{k: measured[k] for k in keys}}

    print(json.dumps({"kernels": [
        entry("batched_det_lu", "det_lu.cu", "det_kernel.py:257",
              hk_launches["K1"], k1),
        entry("batched_det_solve_gj", "gj_det.cu", "det_kernel.py:460",
              wm_launches["K2"], k2),
        entry("batched_det_inv_gj", "gj_det.cu", "det_kernel.py:532",
              wm_launches["K3"], k3),
        entry("wm_diag_derived", "wm_diag.cu", "wm_kernel.py:273",
              wm_as_launches["K5"], k5),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
