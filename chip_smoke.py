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
             time and ptxas' register / shared-memory / spill report of
             every kernel; the script fails if any instantiation of K1, K2,
             K3 or K4 spills;
2. K1      — the batched-determinant kernel against its plain PyTorch
             version and against torch.linalg.det as the oracle, at the
             main path's shape (10000, 6, 6) in complex128 and complex64 and
             at (4096, 45, 45) and (4096, 60, 60) in complex128, on
             well-conditioned inputs I + 0.3 noise / sqrt(r); at both sides
             of its size rule (`ops.det.det_variant`: the rows kernel to
             r = 16, the warp kernel from 17) and of 8 | 9, of the rule of
             `linalg.batched_det` (K1 | K4) and at r = 1, in both types,
             with batches of 10,001 and 1001 that fill no whole warp of
             matrices; then the kernel's and the plain version's median
             times at (10000, 6, 6) complex128 (CUDA events); the same
             call's host time (the C entry point called directly with its
             output allocated once, the wrapper, their difference, the
             floor of a launch at n = 1); and the large-n row (10^6, 6, 6),
             where the device time dominates the call: entry point,
             wrapper and library beside the bound;
3. K2      — the Gauss-Jordan det + solve kernel against its plain version
             and against torch.linalg.det / solve, at the WM path's shapes
             (10000, 6, 6 | 12), (10000, 6, 6 | 6), (10000, 6, 6 | 5) in
             complex128 and complex64 and at the flagship leaf
             (2048, 60, 60 | 120) in complex128; at both sides of its size
             rule (`ops.gj.solve_variant`: the warp kernel to (8 | 56), the
             block kernel from (8 | 57) and (9 | 5)) and at its limits
             ((1 | 1), (64 | 128), B in three chunks at (33 | 159), a batch
             of 10,001 that fills no whole block of the warp kernel,
             complex64 at (45 | 90) and (64 | 128)); times at (10000, 6, 6 |
             12) complex128; checks and times at coumarin's WM leaves (2048,
             45, 45 | 90), (| 45) and (| 5) in complex128 (the plain version
             there in 3 windows of 2 calls: one call takes tens of ms);
4. K3      — the Gauss-Jordan det + inverse kernel the same way against
             torch.linalg.det / inv at (10000, 12, 12) and (10000, 6, 6),
             (2048, 60, 60) and (1024, 64, 64) in complex128 and complex64;
             at both sides of its size rule (`ops.gj.inv_variant`: the rows
             kernel to m = 16, the block kernel from 17, with the largest
             and smallest m of each block layout) and of 8 | 9, with
             ragged batches; times at (10000, 12, 12) complex128; checks
             and times at coumarin's leaf (2048, 45, 45) in complex128 and
             complex64; host times as for K1; the large-n rows (10^6, 6, 6)
             and (10^5, 12, 12); the WM methylium norm's pair-block shape
             (b^2, 6, 6), b the block `hk.pair_block` gives it, checked
             and timed against the plain version and torch.linalg.inv_ex +
             det;
4b. K4     — the block-per-matrix determinant kernel against its plain
             version (K1's) and torch.linalg.det at the sGDML prefactor's
             shape (2048, 45, 45) and at (2048, 64, 64) in complex128 and
             (2048, 45, 45), (2048, 33, 33) and (2048, 64, 64) in complex64;
             times of K4, K1, the plain version
             and torch.linalg.det at (2048, 45, 45) complex128, in turns;
             host times as for K1 (K2's at (10000, 6, 6 | 12) in its phase);
4c. K5     — the fused separable WM kernel against its plain version on
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
             by make_model.py into a temporary directory) as shipped, 98,304
             trajectories x 2000 steps with error bars and its spectrum
             task, through `dynamics` + `rates` + `spectrum` on cuda: finite
             correlations, |C(0) - 1| < 1e-3, 98,304 trajectories, the rate
             energy grid of examples/as_model/correlations_100k_reference.npz
             and the rate at its maximum within 3% of that file's (its
             deviation also in units of ic_rate_stderr); both stderr keys
             finite and positive after step 0, ic_rate_stderr and
             spectrum_stderr finite, |int S(E) dE - Re C(0)| < 1e-2; then
             98,304 x 100 steps with and without error bars at the same
             seed: the same C(t) and k~ic(t), bit for bit;
8. WM AS   — semi_wm.json (cell width 1e4) at the same seed and size: the
             same gates, the rate at its maximum within 4.1e-4 of the HK AS
             run's (10x the JAX package's WM - HK gap at the same draws,
             scripts/as_wm_hk_gap.py), and K5 launched on every step;
8b. sampling — the HK AS example at 32,768 x 200 steps with error bars and
             `sampling` "antithetic", then "sobol": |C(0) - 1| < 1e-3,
             finite stderr, the two sampling-statistics lines logged;
8c. micro_batch — the WM AS example at 98,304 x 200 steps with
             `micro_batch` 8192 against the whole batch at the same seed:
             C(t) and k~ic(t) within 1e-12 of their largest modulus; both
             walls and K5's launches printed;
8d. HK AS norm — examples/as_model/semi_norm.json as shipped (131,072 x
             2000 steps, `calc_norm_every` 500): four norm lines, each
             finite and > 0, with each norm's wall; in memory, the same
             batch at t = 0: its norm equals the first line to the digits
             printed and the norm at half the block size to 1e-9 relative,
             and `norm(sample_pairs=64)` lies within 5 of its stderr of it
             (plus 1e-12 of it: the rounding of a sum in another order);
8e. WM methylium norm — examples/methylium_AH at one batch of 10,000 x 2000
             steps with propagator "WM", cell width 1e4 and
             `calc_norm_every` 1000: every norm finite with K3 launched at
             least once per block pair (K3's launches and ms per norm, and
             |norm(0) - 1| printed); in memory, the same batch at t = 0: its
             norm equals the first line to the digits printed, and the pair
             sum over four block pairs with K3 equals the same sum with
             K3's plain version on the card to 1e-10 relative;
9. coumarin reference — the committed JAX f64 CPU curves
             (tests/data/coumarin_jax_reference.npz, written by
             scripts/coumarin_jax_reference.py) against the port on cuda
             from the file's standard normals and energy origin, with the
             example's potential at an f64 Hessian: HK and WM with
             hessian_eval "taylor", taylor_every 8, scan segments of 500
             over 2000 steps, and HK with hessian_eval "stage" over 200
             steps; every step of C(t) and k~ic(t) within 1e-6 of the file
             curve's largest modulus;
10. HK coumarin — examples/coumarin_gdml/semi.json at its own size (2048
             trajectories x 2000 steps, float32 Hessian, taylor_every 8)
             through `dynamics` + `rates` on cuda: finite correlations,
             |C(0) - 1| < 1e-3, 2048 trajectories, and K4 launched on every
             step;
11. WM coumarin — semi_wm.json (cell width 1e4) at the same seed and size:
             the same gates, the rate at the HK run's maximum within 10x the
             JAX package's WM - HK gap at the same draws (the reference
             file's `wm_hk_gap`), K4 launched on every step, K2 three times
             per step and K3 twice per batch;
12. the kernels' JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

TF32 stays off: the script fails if float32 matmuls would run in TF32.
"""

import json
import logging
import math
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
COUMARIN = ROOT / "examples" / "coumarin_gdml"
COUMARIN_REFERENCE = ROOT / "tests" / "data" / "coumarin_jax_reference.npz"
# card f64 against the JAX package's CPU f64: only the order of sums
# differs (the port on the CPU sits 3.9e-7 from the file over 2000 steps)
REFERENCE_GATE = 1e-6
# WM - HK at the same draws, in multiples of the JAX package's own gap
WM_HK_GAP_FACTOR = 10.0
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
    # both sides of the rows kernel's limit (16 | 17) and of 8 | 9, batches
    # that fill no whole warp of matrices
    (10001, 8, "complex128", 1e-12, 1e-10),
    (10001, 9, "complex128", 1e-12, 1e-10),
    (10001, 9, "complex64", 1e-5, 1e-4),
    (1001, 16, "complex128", 1e-12, 1e-10),
    (1001, 16, "complex64", 1e-5, 1e-4),
    (1001, 17, "complex128", 1e-12, 1e-10),
    (1001, 17, "complex64", 1e-5, 1e-4),
    (1001, 1, "complex128", 1e-12, 1e-10),
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
    # the size rule's two sides and the kernels' limits
    (1001, 1, 1, "complex128", 1e-12, 1e-10),
    (10001, 6, 12, "complex128", 1e-12, 1e-10),
    (2048, 8, 56, "complex128", 1e-12, 1e-10),
    (2048, 8, 57, "complex128", 1e-12, 1e-10),
    (2048, 9, 5, "complex128", 1e-12, 1e-10),
    (1024, 33, 159, "complex128", 1e-12, 1e-10),
    (1024, 64, 128, "complex128", 1e-12, 1e-10),
    (1024, 64, 128, "complex64", 1e-5, 1e-4),
    (2048, 45, 90, "complex64", 1e-5, 1e-4),
]
# (n, r, dtype name, limit kernel-vs-plain, limit vs the c128 oracle)
K4_CASES = [
    (2048, 45, "complex128", 1e-12, 1e-10),
    (2048, 64, "complex128", 1e-12, 1e-10),
    (2048, 45, "complex64", 1e-5, 1e-4),
    (2048, 33, "complex64", 1e-5, 1e-4),
    (2048, 64, "complex64", 1e-5, 1e-4),
]
# coumarin's WM leaves (2r = 90 split at m = 45): K2 (n, m, k), K3 (n, m)
K2_LEAVES = [(2048, 45, 90), (2048, 45, 45), (2048, 45, 5)]
K3_LEAVES = [(2048, 45)]
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
    (2048, 60, "complex64", 1e-5, 1e-4),
    (1024, 64, "complex128", 1e-12, 1e-10),
    (1024, 64, "complex64", 1e-5, 1e-4),
    (2048, 45, "complex64", 1e-5, 1e-4),
    # both sides of the rows kernel's limit (16 | 17) and of 8 | 9, batches
    # that fill no whole warp of matrices; the block layouts' largest m
    (10001, 8, "complex128", 1e-12, 1e-10),
    (10001, 9, "complex128", 1e-12, 1e-10),
    (10001, 9, "complex64", 1e-5, 1e-4),
    (1001, 16, "complex128", 1e-12, 1e-10),
    (1001, 16, "complex64", 1e-5, 1e-4),
    (1001, 17, "complex128", 1e-12, 1e-10),
    (1001, 17, "complex64", 1e-5, 1e-4),
    (1001, 20, "complex128", 1e-12, 1e-10),
    (1001, 21, "complex128", 1e-12, 1e-10),
    (1001, 24, "complex128", 1e-12, 1e-10),
    (1001, 25, "complex64", 1e-5, 1e-4),
    (1001, 28, "complex128", 1e-12, 1e-10),
    (1001, 29, "complex128", 1e-12, 1e-10),
    (1001, 32, "complex128", 1e-12, 1e-10),
    (1001, 33, "complex128", 1e-12, 1e-10),
    (1001, 48, "complex128", 1e-12, 1e-10),
    (1001, 49, "complex128", 1e-12, 1e-10),
    (1001, 1, "complex128", 1e-12, 1e-10),
]
# the rows where the device time dominates a call (the pair blocks of a WM
# norm at r = 6): K1 (n, r), K3 (n, m), complex128
K1_LARGE = [(1000000, 6)]
K3_LARGE = [(1000000, 6), (100000, 12)]
# methylium's Cartesian coordinates and rank, the WM norm's pair matrices
METHYLIUM_DIM, METHYLIUM_RANK = 12, 6


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


class LogLines(logging.Handler):
    """The messages the port's loggers emit while this handler is
    attached (`with LogLines() as log: ...; log.lines`)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logger = logging.getLogger("semiclassical_tpu_torch")
        logger.setLevel(logging.INFO)
        logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("semiclassical_tpu_torch").removeHandler(self)


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


def in_turns(kernel, plain, library, *args, others=None, plain_windows=None):
    """Median per-call ms of the kernel, the plain version, the library
    call (None: not timed) and any `others` (name: callable), timed in
    turns: plain, library, others, kernel, kernel, others reversed,
    library, plain. `plain_windows` = (loops, calls) times the plain
    version in fewer and shorter windows than the rest."""
    import numpy as np
    fns = {"plain": plain, "library": library, **(others or {}),
           "kernel": kernel}
    t = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        if fns[name] is not None:
            loops, calls = (plain_windows if name == "plain" and plain_windows
                            else (10, 20))
            t[name] += median_ms(fns[name], *args, loops=loops, calls=calls)
    med = {name: float(np.median(v)) if v else None for name, v in t.items()}
    return {"ms": med["kernel"], "plain_ms": med["plain"],
            "library_ms": med["library"], "windows": len(t["kernel"]),
            "plain_note": (f" ({len(t['plain'])} windows of "
                           f"{plain_windows[1]} calls)" if plain_windows
                           else ""),
            **{f"{name}_ms": med[name] for name in (others or {})}}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the flops over the FP64 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def timing_line(label, shape, timed, bound_ms, bound_by, library):
    return (f"{label} time at {shape}: kernel {timed['ms']:.4f} ms, plain "
            f"{timed['plain_ms']:.4f} ms{timed['plain_note']}, library "
            f"({library}) "
            + (f"{timed['library_ms']:.4f} ms" if timed["library_ms"]
               is not None else "none")
            + f" per call (median of {timed['windows']} CUDA-event windows "
            f"of 20 calls); bound {bound_ms:.4f} ms by {bound_by}, "
            f"{100 * bound_ms / timed['ms']:.1f}% of it reached")


def lu_flops(n, r):
    """The unpivoted LU determinant's flops: per pivot a reciprocal, r-k-1
    column scalings and the (r-k-1)^2 trailing update, complex (6 and 8
    flops), and the pivot product."""
    return n * sum(8 * (r - k - 1) ** 2 + 6 * (r - k - 1) + 12
                   for k in range(r))


def direct_call(entry, tensors, *ints):
    """A closure that launches the C entry point `entry` of the built
    library on the tensors' pointers, `ints` and the current stream: the
    kernel without its wrapper, the outputs among `tensors` allocated once."""
    import torch

    from semiclassical_tpu_torch.ops import _build
    fn = getattr(_build.load(), entry)
    args = (*(t.data_ptr() for t in tensors), *ints,
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


def direct_det(det, A):
    """K1's entry point on A with the layout of its size rule."""
    import torch
    n, r, _ = A.shape
    out = torch.empty(n, dtype=A.dtype, device=A.device)
    return direct_call("semi_det_lu_c128", (A, out), n, r,
                       det.LAYOUT_CODES[det.det_variant(r)])


def direct_inv(gj, A):
    """K3's entry point on A with the layout of its size rule."""
    import torch
    n, m, _ = A.shape
    out = (torch.empty_like(A), torch.empty(n, dtype=A.dtype,
                                            device=A.device))
    return direct_call("semi_gj_det_inv_c128", (A, *out), n, m,
                       *gj.inv_variant(m)[1:])


def host_line(label, shape, make_direct, wrapper, *args):
    """One line on where a small call's time goes: the C entry point called
    directly, the wrapper, their difference (the wrapper's host time when
    the kernel is shorter than it) and the floor of a launch (the entry
    point at n = 1), in turns direct, wrapper, wrapper, direct."""
    import numpy as np
    direct = make_direct(*args)
    floor = make_direct(*(x[:1].contiguous() for x in args))
    t = {"direct": [], "wrapper": []}
    for name in ("direct", "wrapper", "wrapper", "direct"):
        t[name] += (median_ms(direct, loops=5, calls=50) if name == "direct"
                    else median_ms(wrapper, *args, loops=5, calls=50))
    d, w = (1e3 * float(np.median(t[name])) for name in ("direct", "wrapper"))
    f = 1e3 * float(np.median(median_ms(floor, loops=5, calls=50)))
    print(f"{label} host time at {shape}: entry point called directly "
          f"{d:.1f} us, through the wrapper {w:.1f} us, wrapper minus direct "
          f"{w - d:.1f} us per call; floor of a launch (n = 1) {f:.1f} us "
          f"(median of CUDA-event windows of 50 calls)", flush=True)
    return d / 1e3


def large_row(label, shape, make_direct, wrapper, library, library_name,
              oracle_err, A, bound_ms, bound_by):
    """A row where the device time dominates the call: the entry point
    called directly, the wrapper and the library call in turns (the
    library in 2 windows of 2 calls each way; the plain version is not
    timed at this size), the kernel held against the library's result."""
    import numpy as np
    direct = make_direct(A)
    t = {"library": [], "direct": [], "wrapper": []}
    for name in ("library", "direct", "wrapper", "wrapper", "direct",
                 "library"):
        t[name] += (median_ms(library, A, loops=2, calls=2)
                    if name == "library" else
                    median_ms(direct, loops=5, calls=10) if name == "direct"
                    else median_ms(wrapper, A, loops=5, calls=10))
    d, w, lib = (float(np.median(t[name]))
                 for name in ("direct", "wrapper", "library"))
    err = oracle_err(wrapper(A), A)
    print(f"{label} large-n row {shape} complex128: entry point called "
          f"directly {d:.4f} ms, through the wrapper {w:.4f} ms, library "
          f"({library_name}) {lib:.4f} ms per call, plain version not timed;"
          f" bound {bound_ms:.4f} ms by {bound_by}, "
          f"{100 * bound_ms / d:.1f}% of it reached; max rel err against "
          f"the library's result {err:.3e} (limit 1e-10)", flush=True)
    check(err <= 1e-10, f"{label} at {shape} vs the library: {err}")


def check_cases(label, cases, run, oracle, main_case):
    """Kernel vs plain vs the complex128 oracle on every case; returns the
    largest absolute kernel-plain difference at `main_case`. `run(case,
    dtype)` returns (kernel outputs, plain outputs, oracle inputs), each a
    tuple; `oracle(*inputs)` the complex128 oracle's outputs."""
    import torch

    main_abs_err = None
    for case in cases:
        *shape, dname, lim_kp, lim_oracle = case
        got, plain, inputs = run(shape, getattr(torch, dname))
        ref = oracle(*(x.to(torch.complex128) for x in inputs))
        torch.cuda.synchronize()
        err = lambda xs, ys: max(
            max_rel(x, y) if x.dim() == 1 else max_rel_mat(x, y)
            for x, y in zip(xs, ys))
        e_kp, e_ko, e_po = err(got, plain), err(got, ref), err(plain, ref)
        if tuple(shape) + (dname,) == main_case:
            main_abs_err = max(float((x - y).abs().max())
                               for x, y in zip(got, plain))
        print(f"{label} {tuple(shape)} {dname}: max rel err kernel-plain "
              f"{e_kp:.3e} (limit {lim_kp:g}), kernel-oracle {e_ko:.3e}, "
              f"plain-oracle {e_po:.3e} (limit {lim_oracle:g})", flush=True)
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f"{label} non-finite at {shape} {dname}")
        check(e_kp <= lim_kp, f"{label} kernel vs plain {e_kp} > {lim_kp}")
        check(e_ko <= lim_oracle and e_po <= lim_oracle,
              f"{label} vs oracle {e_ko}, {e_po} > {lim_oracle}")
    return main_abs_err


def k1_phase(det):
    import torch

    from semiclassical_tpu_torch import linalg

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    def run(shape, dtype):
        A = well_conditioned(*shape, dtype, g)
        return (det.batched_det(A),), (det.batched_det_lu_plain(A),), (A,)

    # both sides of the size rule of `linalg.batched_det` (K1 | K4)
    rule = [(1001, r, dname, lim_kp, lim_oracle)
            for r in (linalg.DET_WARP_MAX_R, linalg.DET_WARP_MAX_R + 1)
            for dname, lim_kp, lim_oracle in (("complex128", 1e-12, 1e-10),
                                              ("complex64", 1e-5, 1e-4))]
    main_abs_err = check_cases("K1", K1_CASES + rule, run,
                               lambda A: (torch.linalg.det(A),),
                               (10000, 6, "complex128"))
    n, r = 10000, 6
    A = well_conditioned(n, r, torch.complex128, g)
    timed = in_turns(det.batched_det, det.batched_det_lu_plain,
                     torch.linalg.det, A)
    b = bound(n * (r * r + 1) * 16, lu_flops(n, r))
    print(timing_line("K1", "(10000, 6, 6) complex128", timed, *b,
                      "torch.linalg.det"), flush=True)
    host_line("K1", "(10000, 6, 6) complex128",
              lambda A: direct_det(det, A), det.batched_det, A)
    for n, r in K1_LARGE:
        A = well_conditioned(n, r, torch.complex128, g)
        large_row("K1", (n, r, r), lambda A: direct_det(det, A),
                  det.batched_det, torch.linalg.det, "torch.linalg.det",
                  lambda got, A: max_rel(got, torch.linalg.det(A)), A,
                  *bound(n * (r * r + 1) * 16, lu_flops(n, r)))
        del A
    torch.cuda.empty_cache()
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


def k4_phase(det, det_block):
    """K4 against its plain version and torch.linalg.det; K4, K1, the plain
    version and torch.linalg.det timed in turns at coumarin's prefactor
    shape (2048, 45, 45) complex128."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)

    def run(shape, dtype):
        A = well_conditioned(*shape, dtype, g)
        return ((det_block.batched_det_block(A),),
                (det_block.batched_det_lu_plain(A),), (A,))

    main_abs_err = check_cases("K4", K4_CASES, run,
                               lambda A: (torch.linalg.det(A),),
                               (2048, 45, "complex128"))
    n, r = 2048, 45
    A = well_conditioned(n, r, torch.complex128, g)
    timed = in_turns(det_block.batched_det_block,
                     det_block.batched_det_lu_plain, torch.linalg.det, A,
                     others={"K1": det.batched_det})
    b = bound(n * (r * r + 1) * 16, lu_flops(n, r))
    print(timing_line("K4", "(2048, 45, 45) complex128", timed, *b,
                      "torch.linalg.det")
          + f"; K1 at the same shape {timed['K1_ms']:.4f} ms", flush=True)
    out = torch.empty(n, dtype=A.dtype, device="cuda")
    host_line("K4", "(2048, 45, 45) complex128",
              lambda A: direct_call("semi_det_lu_block_c128",
                                    (A, out[:A.shape[0]]), A.shape[0], r),
              det_block.batched_det_block, A)
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


def gj_solve_flops(n, m, k):
    """Gauss-Jordan on [A | B]: per pivot a reciprocal, the live columns of
    the pivot row scaled and those of the m - 1 other rows updated."""
    return n * sum(6 * (m + k - kp - 1) + 8 * (m - 1) * (m + k - kp - 1)
                   + 12 for kp in range(m))


def gj_inv_flops(n, m):
    """In-place Gauss-Jordan: per pivot the row scaled, m - 1 rows
    updated."""
    return n * sum(6 * m + 8 * (m - 1) * m + 12 for _ in range(m))


def solve_library(A, B):
    import torch
    return torch.linalg.solve(A, B), torch.linalg.det(A)


def inv_library(A):
    import torch
    return torch.linalg.inv_ex(A), torch.linalg.det(A)


def k2_phase(gj):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)

    def run(shape, dtype):
        n, m, k = shape
        A = well_conditioned(n, m, dtype, g)
        B = gaussian((n, m, k), dtype, g)
        print(f"K2 ({m} | {k}): {gj.solve_variant(m, k)}", flush=True)
        return (gj.batched_det_solve_gj(A, B),
                gj.batched_det_solve_gj_plain(A, B), (A, B))

    oracle = lambda A, B: (torch.linalg.det(A), torch.linalg.solve(A, B))
    main_abs_err = check_cases("K2", K2_CASES, run, oracle,
                               (10000, 6, 12, "complex128"))
    check_cases("K2", [(*leaf, "complex128", 1e-12, 1e-10)
                       for leaf in K2_LEAVES], run, oracle, None)
    results = {}
    for n, m, k in [(10000, 6, 12)] + K2_LEAVES:
        A = well_conditioned(n, m, torch.complex128, g)
        B = gaussian((n, m, k), torch.complex128, g)
        timed = in_turns(gj.batched_det_solve_gj,
                         gj.batched_det_solve_gj_plain, solve_library, A, B,
                         plain_windows=(3, 2) if m > 6 else None)
        b = bound(n * (m * m + 2 * m * k + 1) * 16, gj_solve_flops(n, m, k))
        print(timing_line("K2", f"({n}, {m}, {m} | {k}) complex128", timed,
                          *b, "torch.linalg.solve + det"), flush=True)
        results[(n, m, k)] = dict(timed, bound_ms=b[0], bound_by=b[1])
        if m == 6:
            host_line(
                "K2", f"({n}, {m}, {m} | {k}) complex128",
                lambda A, B: direct_call(
                    "semi_gj_det_solve_c128",
                    (A, B, torch.empty_like(B),
                     torch.empty(A.shape[0], dtype=A.dtype, device="cuda")),
                    A.shape[0], m, k, *gj.solve_variant(m, k)[1:]),
                gj.batched_det_solve_gj, A, B)
    print(f"K2 at coumarin's three leaves: "
          f"{sum(results[leaf]['ms'] for leaf in K2_LEAVES):.4f} ms in all",
          flush=True)
    return dict(results[(10000, 6, 12)], max_abs_err=main_abs_err)


def k3_phase(gj):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 3)

    def run(shape, dtype):
        A = well_conditioned(*shape, dtype, g)
        return (gj.batched_det_inv_gj(A), gj.batched_det_inv_gj_plain(A),
                (A,))

    oracle = lambda A: (torch.linalg.det(A), torch.linalg.inv(A))
    main_abs_err = check_cases("K3", K3_CASES, run, oracle,
                               (10000, 12, "complex128"))
    check_cases("K3", [(*leaf, "complex128", 1e-12, 1e-10)
                       for leaf in K3_LEAVES], run, oracle, None)
    results = {}
    for n, m in [(10000, 12)] + K3_LEAVES:
        A = well_conditioned(n, m, torch.complex128, g)
        timed = in_turns(gj.batched_det_inv_gj, gj.batched_det_inv_gj_plain,
                         inv_library, A)
        b = bound(n * (2 * m * m + 1) * 16, gj_inv_flops(n, m))
        print(timing_line("K3", f"({n}, {m}, {m}) complex128", timed, *b,
                          "torch.linalg.inv_ex + det"), flush=True)
        results[(n, m)] = dict(timed, bound_ms=b[0], bound_by=b[1])
        host_line("K3", f"({n}, {m}, {m}) complex128",
                  lambda A: direct_inv(gj, A), gj.batched_det_inv_gj, A)

    def oracle_err(got, A):
        ref = torch.linalg.inv(A)
        err = max(max_rel(got[0], torch.linalg.det(A)),
                  max_rel_mat(got[1], ref))
        del ref
        return err

    for n, m in K3_LARGE:
        del A
        torch.cuda.empty_cache()
        A = well_conditioned(n, m, torch.complex128, g)
        large_row("K3", (n, m, m), lambda A: direct_inv(gj, A),
                  gj.batched_det_inv_gj, inv_library,
                  "torch.linalg.inv_ex + det", oracle_err, A,
                  *bound(n * (2 * m * m + 1) * 16, gj_inv_flops(n, m)))
    del A
    torch.cuda.empty_cache()

    # the WM methylium norm's pair blocks: (b^2, r, r) with b the block the
    # memory rule gives 10,000 trajectories at d = 12, r = 6
    from semiclassical_tpu_torch.propagation import hk, wm
    m = METHYLIUM_RANK
    b = hk.pair_block(10000, wm.wm_pair_bytes(METHYLIUM_DIM, m), "cuda")
    n = b * b
    main_abs_err = check_cases(
        "K3 pair block", [(n, m, "complex128", 1e-12, 1e-10)], run, oracle,
        (n, m, "complex128"))
    A = well_conditioned(n, m, torch.complex128, g)
    timed = in_turns(gj.batched_det_inv_gj, gj.batched_det_inv_gj_plain,
                     inv_library, A, plain_windows=(3, 2))
    bnd = bound(n * (2 * m * m + 1) * 16, gj_inv_flops(n, m))
    print(timing_line("K3", f"the WM norm's pair block ({b}^2 = {n}, {m}, "
                      f"{m}) complex128", timed, *bnd,
                      "torch.linalg.inv_ex + det"), flush=True)
    del A
    torch.cuda.empty_cache()
    return dict(timed, max_abs_err=main_abs_err, bound_ms=bnd[0],
                bound_by=bnd[1])


def reset_counts(ops):
    """Set every kernel's launch count to 0."""
    ops["det"].LAUNCHES = 0
    ops["det_block"].LAUNCHES = 0
    for name in ops["gj"].LAUNCHES:
        ops["gj"].LAUNCHES[name] = 0
    ops["wm_diag"].LAUNCHES = 0


def read_counts(ops):
    return {"K1": ops["det"].LAUNCHES, "K2": ops["gj"].LAUNCHES["det_solve"],
            "K3": ops["gj"].LAUNCHES["det_inv"],
            "K4": ops["det_block"].LAUNCHES, "K5": ops["wm_diag"].LAUNCHES}


def run_path(cli, ops, config, dynamics_keys, tmp):
    """Run `config`'s dynamics task (updated with `dynamics_keys`), then its
    rates and spectrum tasks, through the port's CLI on cuda, writing into
    `tmp`; every launch count is set to 0 just before the dynamics command
    and read just after. Returns (the npz as a dict, the launches, the
    dynamics task, the dynamics command's wall seconds, the port's log
    lines of the dynamics command)."""
    import numpy as np
    import torch

    npz = str(pathlib.Path(tmp) / "correlations.npz")
    for task in config["semi"]:
        if task["task"] == "dynamics":
            task.update(dynamics_keys, manual_seed=SEED)
            task["results"]["correlations"] = npz
            dynamics = task
        else:
            task.update(correlations=npz,
                        **{task["task"]: npz})   # rates / spectrum output
    cfg = str(pathlib.Path(tmp) / "semi.json")
    with open(cfg, "w") as f:
        json.dump(config, f, indent=1)

    reset_counts(ops)
    t0 = time.perf_counter()
    with LogLines() as log:
        rc = cli.main(["dynamics", cfg, "--device", "cuda"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(ops)
    check(rc == 0, f"dynamics returned {rc}")
    for command in ("rates", "spectrum"):
        check(cli.main([command, cfg]) == 0, f"{command} failed")
    return dict(np.load(npz)), launches, dynamics, wall, log.lines


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
        data, launches, task, wall, _ = run_path(cli, ops, config,
                                                 task_keys, tmp)
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


def as_config(file, model, **dynamics_keys):
    """examples/as_model/`file` with its model file at `model` and
    `dynamics_keys` set on the dynamics task."""
    with open(AS_EXAMPLE / file) as f:
        config = json.load(f)
    for task in config["semi"]:
        if task["task"] == "dynamics":
            task["potential"]["model_file"] = model
            task.update(dynamics_keys)
    return config


def as_run(cli, ops, smi, model, label, file):
    """examples/as_model/`file` as shipped, at its own size, through the
    port's CLI on cuda; the error-bar and spectrum gates where the file
    asks for them."""
    import numpy as np

    config = as_config(file, model)
    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall, _ = run_path(cli, ops, config, {}, tmp)
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
    if task.get("error_bars"):
        ec, ek = data["autocorrelation_stderr"], data["ic_correlation_stderr"]
        check(bool(np.isfinite(ec).all() and np.isfinite(ek).all()
                   and (ec[1:] > 0).all() and (ek[1:] > 0).all()),
              f"{label} AS stderr not finite and positive after step 0")
        band = float(data["ic_rate_stderr"])
        ref = np.load(AS_REFERENCE)["ic_rate"][imax]
        print(f"{label} AS error bars: max stderr C(t) {ec.max():.3e}, "
              f"k~ic(t) {ek.max():.3e}; rate at max - reference = "
              f"{(data['ic_rate'][imax] - ref) / band:+.3f} ic_rate_stderr "
              f"({band:.4e} s^-1)", flush=True)
        check(np.isfinite(band), f"{label} AS ic_rate_stderr {band}")
    if "spectrum" in data:
        s, e = data["spectrum"], data["spectrum_energies"]
        total = float(np.sum(0.5 * (s[1:] + s[:-1]) * np.diff(e)))
        dev = abs(total - data["autocorrelation"][0].real)
        band = float(data.get("spectrum_stderr", np.nan))
        print(f"{label} AS spectrum: int S(E) dE = {total:.6f}, "
              f"|int S dE - Re C(0)| = {dev:.3e} (gate 1e-2), "
              f"spectrum_stderr {band:.4e}", flush=True)
        check(bool(np.isfinite(s).all()), f"{label} AS spectrum not finite")
        check(dev < 1e-2, f"{label} AS spectrum integral off by {dev}")
        check(np.isfinite(band), f"{label} AS spectrum_stderr {band}")
    data.update(imax=imax, nsteps=nsteps, nrep=nrep)
    return data, launches


def error_bars_identity(cli, ops, model):
    """The HK AS example at 98,304 x 100 steps with and without error
    bars at one seed: the same C(t) and k~ic(t), bit for bit."""
    import numpy as np

    out = {}
    for eb in (True, False):
        with tempfile.TemporaryDirectory() as tmp:
            data, _, _, wall, _ = run_path(
                cli, ops, as_config("semi.json", model, num_steps=100,
                                    error_bars=eb), {}, tmp)
        out[eb] = (data, wall)
    same = all(np.array_equal(out[True][0][k], out[False][0][k])
               for k in ("autocorrelation", "ic_correlation"))
    print(f"HK AS 98304 x 100 steps: dynamics command {out[True][1]:.3f} s "
          f"with error bars, {out[False][1]:.3f} s without; C(t) and k~ic(t)"
          f" identical: {same}", flush=True)
    check(same, "error bars changed C(t) or k~ic(t)")


def sampling_phase(cli, ops, smi, model):
    """The HK AS example at 32,768 x 200 steps with error bars under
    antithetic and sobol sampling."""
    import numpy as np

    for method in ("antithetic", "sobol"):
        with tempfile.TemporaryDirectory() as tmp:
            data, _, task, wall, lines = run_path(
                cli, ops, as_config("semi.json", model, batch_size=32768,
                                    num_trajectories=32768, num_steps=200,
                                    sampling=method), {}, tmp)
        stats = [line for line in lines if line.startswith(
            ("max |<z> - z0| / sigma", "max |cov(z) - analytic| / sigma2"))]
        c0 = abs(data["autocorrelation"][0] - 1.0)
        ec, ek = data["autocorrelation_stderr"], data["ic_correlation_stderr"]
        print(f"sampling {method}: HK AS 32768 x 200 steps, dynamics "
              f"command {wall:.3f} s [{smi}]; |C(0) - 1| = {c0:.2e}; max "
              f"stderr C(t) {ec.max():.3e}, k~ic(t) {ek.max():.3e}; "
              + "; ".join(" ".join(line.split()) for line in stats),
              flush=True)
        check(len(stats) == 2, f"sampling {method}: statistics lines {stats}")
        check(c0 < 1e-3, f"sampling {method}: |C(0) - 1| = {c0}")
        check(bool(np.isfinite(ec).all() and np.isfinite(ek).all()),
              f"sampling {method}: stderr not finite")


def micro_phase(cli, ops, smi, model):
    """The WM AS example at 98,304 x 200 steps with micro_batch 8192
    against the whole batch at the same seed."""
    import numpy as np

    runs = {}
    for micro in (0, 8192):
        with tempfile.TemporaryDirectory() as tmp:
            data, launches, _, wall, _ = run_path(
                cli, ops, as_config("semi_wm.json", model, num_steps=200,
                                    micro_batch=micro), {}, tmp)
        runs[micro] = (data, launches, wall)
    errs = [float(np.abs(runs[8192][0][k] - runs[0][0][k]).max()
                  / np.abs(runs[0][0][k]).max())
            for k in ("autocorrelation", "ic_correlation")]
    print(f"micro_batch: WM AS 98304 x 200 steps, dynamics command "
          f"{runs[0][2]:.3f} s whole ({runs[0][1]['K5']} K5 launches), "
          f"{runs[8192][2]:.3f} s in sub-batches of 8192 "
          f"({runs[8192][1]['K5']} K5 launches) [{smi}]; max |C - C_whole| /"
          f" max |C_whole| {errs[0]:.3e}, k~ic {errs[1]:.3e} (gate 1e-12)",
          flush=True)
    check(max(errs) <= 1e-12, f"micro_batch vs whole batch: {errs}")


class NormCalls:
    """Wraps a propagator class's `norm` while active, recording each
    call's wall seconds and K3 launches."""

    def __init__(self, cls, gj):
        self.cls, self.gj, self.calls = cls, gj, []

    def __enter__(self):
        import torch
        orig = self.orig = self.cls.norm

        def norm(prop, *args, **kwargs):
            before = self.gj.LAUNCHES["det_inv"]
            t0 = time.perf_counter()
            out = orig(prop, *args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0,
                               self.gj.LAUNCHES["det_inv"] - before))
            return out

        self.cls.norm = norm
        return self

    def __exit__(self, *exc):
        self.cls.norm = self.orig


def same_as_printed(value, printed):
    """`value` equals a norm the CLI printed with six decimals."""
    return abs(value - printed) <= max(1e-6, 1e-12 * abs(printed))


def norm_lines(lines):
    """The norm values of the CLI's norm lines."""
    return [float(line.split("norm=")[1].split("+-")[0])
            for line in lines if "norm=" in line]


def first_batch(cli, task, cls, *args):
    """The first repetition's batch of `task` at t = 0, drawn as the CLI
    draws it at seed SEED."""
    import torch

    potential, q0, p0, G, _, _ = cli._build_potential(task, "cuda")
    prop = cls(G, G, *args, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cli._repetition_seed(SEED, 0))
    prop.initial_conditions(q0, p0, G, potential,
                            ntraj=min(task["batch_size"],
                                      task["num_trajectories"]),
                            generator=gen)
    return prop


def hk_norm_phase(cli, ops, smi, model):
    """examples/as_model/semi_norm.json as shipped, and its first batch
    at t = 0 in memory."""
    import numpy as np

    from semiclassical_tpu_torch.propagation import HermanKlukPropagator, hk

    config = as_config("semi_norm.json", model)
    with tempfile.TemporaryDirectory() as tmp, \
            NormCalls(HermanKlukPropagator, ops["gj"]) as calls:
        data, _, task, wall, lines = run_path(cli, ops, config, {}, tmp)
    norms = norm_lines(lines)
    print(f"HK AS norm {task['num_trajectories']} x {task['num_steps']} "
          f"steps: dynamics command {wall:.3f} s [{smi}]; norms "
          f"{norms}, each in {[round(c[0], 3) for c in calls.calls]} s",
          flush=True)
    check(len(norms) == 4 and all(np.isfinite(x) and x > 0 for x in norms),
          f"HK AS norm lines {norms}")
    check(abs(data["autocorrelation"][0] - 1.0) < 1e-3, "HK AS norm C(0)")

    prop = first_batch(cli, task, HermanKlukPropagator)
    exact = prop.norm()
    half = prop.norm(block=2048)
    est, err = prop.norm(sample_pairs=64, key=0)
    rel = abs(half - exact) / exact
    nb = task["batch_size"] // hk.pair_block(task["batch_size"],
                                             hk.HK_PAIR_BYTES, "cuda")
    print(f"HK AS norm at t = 0 in memory: {exact:.9f} (the CLI's first "
          f"line {norms[0]:.6f}), at half the block {half:.9f} (rel dev "
          f"{rel:.3e}, gate 1e-9), sampled over 64 of {nb * (nb - 1) // 2} "
          f"off-diagonal block pairs "
          f"{est:.6f} +- {err:.6f} ({(est - exact) / max(err, 1e-300):+.2f} "
          "stderr)", flush=True)
    check(same_as_printed(exact, norms[0]), "HK AS t = 0 norm differs from "
          "the CLI's first line")
    check(rel <= 1e-9, f"HK AS norm at half the block: {rel}")
    # within 5 of its stderr, and the rounding of a sum in another order
    check(err > 0 and abs(est - exact) <= 5.0 * err + 1e-12 * exact,
          f"HK AS subsampled norm {est} +- {err} vs {exact}")


def wm_norm_phase(cli, ops, smi):
    """examples/methylium_AH as one WM batch of 10,000 with
    calc_norm_every 1000, and that batch at t = 0 in memory. Returns the
    launches of the dynamics command."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch.ops import gj
    from semiclassical_tpu_torch.propagation import (
        WaltonManolopoulosPropagator, hk, wm)

    with open(EXAMPLE) as f:
        config = json.load(f)
    for task in config["semi"]:
        if task["task"] == "dynamics":
            for key in ("ground", "excited", "coupling"):
                task["potential"][key] = str(
                    (EXAMPLE.parent / task["potential"][key]).resolve())
    keys = dict(propagator="WM", cell_width=CELL_WIDTH, batch_size=10000,
                num_trajectories=10000, calc_norm_every=1000)
    with tempfile.TemporaryDirectory() as tmp, \
            NormCalls(WaltonManolopoulosPropagator, gj) as calls:
        data, launches, task, wall, lines = run_path(cli, ops, config, keys,
                                                     tmp)
    norms = norm_lines(lines)
    n = task["batch_size"]
    prop = first_batch(cli, task, WaltonManolopoulosPropagator, CELL_WIDTH,
                       CELL_WIDTH)
    d, r = prop.params.dim, prop.params.rank
    block = hk.pair_block(n, wm.wm_pair_bytes(d, r), "cuda")
    nb = -(-n // block)
    print(f"WM methylium norm {n} x {task['num_steps']} steps: dynamics "
          f"command {wall:.3f} s [{smi}]; launches {json.dumps(launches)}; "
          f"norms {norms}; |norm(0) - 1| = {abs(norms[0] - 1.0):.4e}; per "
          f"norm: block {block}, {nb} x {nb} block pairs, K3 launches "
          f"{[c[1] for c in calls.calls]}, "
          f"{[round(1e3 * c[0], 1) for c in calls.calls]} ms", flush=True)
    check(len(norms) == task["num_steps"] // task["calc_norm_every"]
          and all(np.isfinite(norms)), f"WM methylium norms {norms}")
    check(all(c[1] >= nb * nb for c in calls.calls),
          f"WM methylium norm: K3 launched {[c[1] for c in calls.calls]} "
          f"times for {nb * nb} block pairs")
    check(np.isfinite(data["autocorrelation"]).all(), "WM methylium C(t)")

    exact = prop.norm()
    log_v, derived = prop._log_coefficients_and_derived()

    def plain(A):
        det, inv = gj.batched_det_inv_gj_plain(
            A.reshape((-1,) + A.shape[-2:]).contiguous())
        return det.reshape(A.shape[:-2]), inv.reshape(A.shape)

    pairs = [(0, 0), (0, 1), (nb - 1, 2), (nb - 1, nb - 1)]
    sums = []
    for det_inv in (None, plain):
        pack, arrays = wm.wm_norm_arrays(prop.params, prop.bc, prop.state,
                                         derived, log_v, det_inv)
        sums.append(hk.blocked_pair_sum(wm._wm_norm_block_term, pack, arrays,
                                        block, hermitian=False, pairs=pairs))
    rel = abs(sums[0] - sums[1]) / abs(sums[1])
    print(f"WM methylium norm at t = 0 in memory: {exact:.9f} (the CLI's "
          f"first line {norms[0]:.6f}); pair sum over block pairs {pairs} "
          f"with K3 {sums[0]:.12e}, with its plain version {sums[1]:.12e}: "
          f"rel dev {rel:.3e} (gate 1e-10)", flush=True)
    check(same_as_printed(exact, norms[0]), "WM methylium t = 0 norm "
          "differs from the CLI's first line")
    check(rel <= 1e-10, f"WM norm pair sum, K3 vs plain: {rel}")
    del prop, derived, arrays
    torch.cuda.empty_cache()
    return launches, dict(block=block, n=n, d=d, r=r)


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


def coumarin_task(file):
    """examples/coumarin_gdml/`file` with its paths made absolute."""
    with open(COUMARIN / file) as f:
        config = json.load(f)
    for task in config["semi"]:
        if task["task"] == "dynamics":
            for key in ("ground", "excited", "coupling"):
                task["potential"][key] = str(
                    (COUMARIN / task["potential"][key]).resolve())
    return config


def reference_phase(cli):
    """The committed JAX f64 CPU curves of the coumarin example against the
    port on cuda, from the file's standard normals and energy origin, with
    the example's potential at an f64 Hessian."""
    import dataclasses

    import numpy as np
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    ref = np.load(COUMARIN_REFERENCE)
    task = next(t for t in coumarin_task("semi.json")["semi"]
                if t["task"] == "dynamics")
    task["potential"].pop("hess_dtype")
    check(task["potential"]["taylor_every"] == int(ref["taylor_every"]),
          "the reference file's taylor_every is not the example's")
    potential, q0, p0, G, zpe, _ = cli._build_potential(task, "cuda")
    print(f"coumarin reference: energy origin on the card "
          f"{potential.origin:.10f} Ha, the file's {float(ref['origin']):.10f}"
          f" Ha (the file's is used)", flush=True)
    potential = dataclasses.replace(potential, origin=float(ref["origin"]))
    dt = task["time_step_fs"] / units.autime_to_fs
    normals = torch.as_tensor(ref["normals"], device="cuda")
    stage = dataclasses.replace(potential, hessian_eval="stage",
                                taylor_every=1)
    cell = float(ref["cell_width"])
    runs = [("HK", HermanKlukPropagator(G, G, device="cuda"), potential,
             int(ref["steps"]), "hk"),
            ("WM", WaltonManolopoulosPropagator(G, G, cell, cell,
                                                device="cuda"),
             potential, int(ref["steps"]), "wm"),
            ("HK stage", HermanKlukPropagator(G, G, device="cuda"), stage,
             int(ref["stage_steps"]), "stage")]
    for label, prop, pot, nt, tag in runs:
        prop.initial_conditions(q0, p0, G, pot, ntraj=int(ref["ntraj"]),
                                normals=normals)
        t0 = time.perf_counter()
        cauto, kic = prop.propagate(pot, dt, nt, energy0_es=zpe,
                                    chunk=int(ref["chunk"]))
        wall = time.perf_counter() - t0
        errs = []
        for got, name in ((cauto, f"cauto_{tag}"), (kic, f"kic_{tag}")):
            want = ref[name]
            check(got.shape == want.shape, f"{label} reference {name} shape")
            errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
        print(f"coumarin reference {label} {prop.ntraj} x {nt} steps "
              f"({wall:.1f} s): max |C - C_ref| / max |C_ref| {errs[0]:.3e},"
              f" k~ic {errs[1]:.3e} (gate {REFERENCE_GATE:g})", flush=True)
        check(max(errs) <= REFERENCE_GATE,
              f"coumarin reference {label}: {errs} > {REFERENCE_GATE}")
        del prop
    torch.cuda.empty_cache()
    return float(ref["wm_hk_gap"])


def coumarin_run(cli, ops, smi, label, file):
    """examples/coumarin_gdml/`file` at its own size through the port's CLI
    on cuda. Returns (the rates npz as a dict, the kernels' launches during
    the dynamics command)."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall, _ = run_path(
            cli, ops, coumarin_task(file), {}, tmp)
    nsteps, ntraj = task["num_steps"], task["num_trajectories"]
    nrep = max(ntraj // task["batch_size"], 1)
    print(f"{label} coumarin {ntraj} x {nsteps} steps ({nrep} batch): "
          f"dynamics command {wall:.3f} s wall, {ntraj * nsteps / wall:.0f} "
          f"traj-steps/s [{smi}]; launches {json.dumps(launches)}",
          flush=True)
    cauto, kic = data["autocorrelation"], data["ic_correlation"]
    check(cauto.shape == (nsteps,) and kic.shape == (nsteps,),
          f"{label} coumarin correlation shapes {cauto.shape}, {kic.shape}")
    check(bool(np.isfinite(cauto).all() and np.isfinite(kic).all()
               and np.isfinite(data["ic_rate"]).all()),
          f"{label} coumarin non-finite correlations or rate")
    c0_dev = abs(cauto[0] - 1.0)
    check(c0_dev < 1e-3, f"{label} coumarin |C(0) - 1| = {c0_dev}")
    check(int(data["trajectories"]) == ntraj,
          f"{label} coumarin accumulated {data['trajectories']} trajectories")
    check(launches["K4"] >= nsteps * nrep,
          f"{label} coumarin: K4 launched {launches['K4']} times for "
          f"{nsteps} x {nrep} steps")
    imax = int(np.argmax(data["ic_rate"]))
    print(f"{label} coumarin: |C(0) - 1| = {c0_dev:.2e}, rate at max "
          f"{data['ic_rate'][imax]:.6e} at {data['energies'][imax]:.6f}",
          flush=True)
    data.update(imax=imax, nsteps=nsteps, nrep=nrep)
    return data, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli
    from semiclassical_tpu_torch.ops import _build, det, det_block, gj, wm_diag

    ops = {"det": det, "det_block": det_block, "gj": gj, "wm_diag": wm_diag}
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would run in TF32")
    print(f"TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32} (no convolution runs), "
          f"float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.3f} s "
          f"({' '.join(_build.NVCC_FLAGS)})", flush=True)
    entry = ""
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print(f"build: {line.strip()}", flush=True)
        if "Compiling entry" in line:
            entry = line
        if "spill" in line and ("det_lu" in entry or "gj_" in entry):
            check("0 bytes spill stores, 0 bytes spill loads" in line,
                  f"an elimination kernel (K1-K4) spills: {entry.strip()}: "
                  f"{line.strip()}")

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
        k4 = phase("K4", k4_phase, det, det_block)
        k5 = phase("K5", k5_phase, cli, wm_diag, model)
        hk, hk_launches = phase("HK methylium", methylium_run, cli, ops, smi,
                                "HK")
        wm_launches = phase("WM methylium", wm_phase, cli, ops, smi, hk)
        hk_as, _ = phase("HK AS", as_run, cli, ops, smi, model, "HK",
                         "semi.json")
        phase("HK AS error bars", error_bars_identity, cli, ops, model)
        wm_as, wm_as_launches = phase("WM AS", as_run, cli, ops, smi, model,
                                      "WM", "semi_wm.json")
        phase("sampling", sampling_phase, cli, ops, smi, model)
        phase("micro_batch", micro_phase, cli, ops, smi, model)
        phase("HK AS norm", hk_norm_phase, cli, ops, smi, model)
    wm_norm_launches, _ = phase("WM methylium norm", wm_norm_phase, cli, ops,
                                smi)
    wm_vs_hk("AS", wm_as, hk_as, WM_HK_GATE_AS)
    steps = wm_as["nsteps"] * wm_as["nrep"]
    check(wm_as_launches["K5"] >= steps,
          f"WM AS: K5 launched {wm_as_launches['K5']} times for {steps} "
          "steps")
    gap = phase("coumarin reference", reference_phase, cli)
    hk_c, hk_c_launches = phase("HK coumarin", coumarin_run, cli, ops, smi,
                                "HK", "semi.json")
    wm_c, wm_c_launches = phase("WM coumarin", coumarin_run, cli, ops, smi,
                                "WM", "semi_wm.json")
    wm_vs_hk("coumarin", wm_c, hk_c, WM_HK_GAP_FACTOR * gap)
    steps = wm_c["nsteps"] * wm_c["nrep"]
    check(wm_c_launches["K2"] >= 3 * steps,
          f"WM coumarin: K2 launched {wm_c_launches['K2']} times for "
          f"{steps} steps")
    check(wm_c_launches["K3"] >= 2 * wm_c["nrep"],
          f"WM coumarin: K3 launched {wm_c_launches['K3']} times for "
          f"{wm_c['nrep']} batches")
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
              wm_norm_launches["K3"], k3),
        entry("batched_det_lu_block", "det_lu_block.cu", "det_kernel.py:113",
              hk_c_launches["K4"], k4),
        entry("wm_diag_derived", "wm_diag.cu", "wm_kernel.py:273",
              wm_as_launches["K5"], k5),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
