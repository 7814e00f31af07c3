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
FP64 peak of 34 TFLOP/s, or the FP32 peak of 67 TFLOP/s for a complex64 /
float32 row (NVIDIA's H100 SXM data sheet); each kernel is also timed at
the reduced-precision modes' type at the paths' shapes (K1 (10^4, 6, 6),
K2 (10^4, 6, 6 | 12) and coumarin's leaves, K3 (10^4, 12, 12), (2048, 45,
45) and the WM norm's pair block, K4 (2048, 45, 45) at complex64; K5
(98304, 60) at float32). Phases, one line each, each with its wall time:

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
4c. K5     — ptxas' registers and spills of every instantiation (the
             script fails if one spills); the fused separable WM kernel
             against its plain version on the 60-mode AS example's WM
             state after 10 steps, at (98304, 60), (8192, 60) and (1000, 5)
             in float64, (98304, 60) in float32 and (98305, 60) in both (a
             batch that fills no whole block), and on the planes
             `wm.wm_diag_inputs` gives for a 5-mode state at n = 1001 in
             both and a 6-mode one in float32 (Mqq .. Mpp views of one
             (4, n, d) tensor, not 16-byte aligned: the scalar variant of
             its layout rule, as at odd d; every other case runs the
             vector variant, and the script checks which ran),
             every output row within 1e-12 (float64) / 1e-5 (float32) of
             its own largest entry; times at (98304, 60) float64 and
             float32; its C entry point called directly with the layout of
             its rule (the outputs allocated once) in turns with the
             wrapper, beside the byte bound and the share of it, in both
             types;
4d. K6     — ptxas' registers and spills of its instantiations (the
             script fails if one spills); the diagonal monodromy's RK4 step
             against its plain version on the AS model's monodromy planes
             (identity plus noise) and Morse stage Hessian diagonals at
             four displaced geometries, at (98304, 60) in float64 and
             float32 (the vector variant), at n = 1, at (1001, 61) (odd n
             d: the scalar variant), on a sub-batch's view Z[:, a:b] of a
             (4, 98304, 60) state (aligned: vector; at an odd offset:
             scalar), with one stage tensor passed four times (the frozen
             modes) and with a broadcast row (the harmonic model): the
             largest difference relative to the planes' largest entry
             within 1e-14 (float64) / 1e-5 (float32), one launch a call,
             the variant checked; times at (98304, 60) float64 and
             float32 in turns with the plain version, and its C entry
             point called directly (the output allocated once), beside
             the byte bound (12 planes) and the share of it;
4e. K7     — ptxas' registers and spills of its instantiations (the
             script fails if one spills); the separable Morse RK4 step
             (the four stages, the RK4 sums, h1..h4 for K6) against its
             plain version on the AS potential at classical-scale q and
             p, at (98304, 60) in float64 and float32 (the vector
             variant), on the rows 8192:16384 of a (98304, 60) state
             (vector) and 1:1002 of a (98304, 61) one (scalar), at (1001,
             61) (odd d: scalar) and at n = 1: q, p and h1..h4 bit for
             bit, S and e1 within 1e-14 (float64) / 1e-5 (float32) of
             their largest entry, one launch a call, the variant checked;
             times at (98304, 60) float64 and float32 in turns with the
             plain version, and its C entry point called directly (the
             outputs allocated once), beside the byte bound (8 planes and
             3 numbers a row) and the share of it; the HK and WM AS
             phases check K7's launches >= steps;
5. HK methylium — examples/methylium_AH at its own size (50,000
             trajectories x 2000 steps, batches of 10,000) through the
             port's `cli.main(["dynamics", ...])` and
             `cli.main(["rates", ...])` on cuda: finite correlations,
             |C(0) - 1| < 1e-3, the rate at its maximum within 3% of
             tests/data/methylium_reference_rate_10k.npz, K1 launched on
             every step of the run, and the five batches through one time
             loop: one capture and one eager block per block length for
             the run (every methylium run through the CLI is held so);
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
             seed: the same C(t) and k~ic(t), bit for bit; K6 launched on
             every step;
8. WM AS   — semi_wm.json (cell width 1e4) at the same seed and size: the
             same gates, the rate at its maximum within 4.1e-4 of the HK AS
             run's (10x the JAX package's WM - HK gap at the same draws,
             scripts/as_wm_hk_gap.py), and K5 launched on every step;
6b. HK methylium exact — the HK methylium run with `integrator` "exact"
             at the same seed and size: the same gates, max_t |C_exact -
             C_rk4| against the HK methylium run within 10x the JAX
             package's gap at the same draws (EXACT_RK4_GAP_JAX, held by
             tests/test_torch_port_exact_gap.py), K1 on every step, and
             ms and launches per step beside the RK4 run's;
6c. WM methylium exact — the same with propagator "WM": the rate at the HK
             exact run's maximum within 1e-3 of it, K2 three times per
             step;
8a. HK AS exact, WM AS exact — semi.json and semi_wm.json as shipped
             plus `integrator` "exact": the AS gates, the C(t) gap to the
             HK AS / WM AS runs gated as for methylium, the RK4-routed rows
             of the 98,304, K5 on every WM step, ms per step;
8a'. AS exact coarse dt — HK AS exact at 16 x time_step_fs over 2000 /
             16 steps: C(t) against every 16th point of the full exact run
             printed (the RK4-routed rows and the branch tracking of
             sqrt(C^2) at the coarse step move it); in memory, the first
             batch fine and coarse: q, p, S, the monodromy planes and C^2
             of the closed-form rows at t = 2000 dt within 1e-9 of each
             field's largest value, and the rows whose branch signs differ
             counted;
8a''. checkpoint — HK AS exact with `checkpoint` and `checkpoint_every`
             500, killed from the progress callback after its second
             segment and resumed in the same process: C(t), k~ic(t) and
             their stderr within 1e-10 of the uninterrupted exact run's,
             with the seconds per checkpoint write and the file's size;
8b. sampling — the HK AS example at 32,768 x 200 steps with error bars and
             `sampling` "antithetic", then "sobol": |C(0) - 1| < 1e-3,
             finite stderr, the two sampling-statistics lines logged;
8c. micro_batch — the WM AS example at 98,304 x 100 steps with
             `micro_batch` 8192 against the whole batch at the same seed:
             C(t) and k~ic(t) within 1e-12 of their largest modulus; both
             walls and K5's launches printed; the 12 sub-batches share the
             graphs: at most 2 captures;
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
P. the precision modes (`--precision`), each at its f64 phase's seed and
             size, with a line naming the mode, the dtypes of q, qc, Z and
             S after 2 steps of the first batch and the launches by dtype;
             TF32 is checked off first:
   HK / WM methylium mixed — after 6, the first batch of the example in
             memory (10,000 x 500 steps; cut from the five batches of 2000
             steps of the CLI run to keep the script near 900 s) at f64
             and at mixed
             from the same draws: C(t) within 1e-4 and k~ic(t) within 1e-3
             of the f64 batch's largest modulus, K1 at complex64 on every
             step (and K2 three times per WM step), no complex128 launch
             of K1-K4;
   HK / WM AS comp32 — after 8: within 6e-4 (C) and 1.5e-3 (k~ic) of the
             f64 runs, the AS gates, K5 at float32 on every WM step;
   HK AS f32 — 98,304 x 200 steps (cut from 2000) at f32 and at f64, C(t)
             within 5e-2 and k~ic(t) within 1e-1;
   WM methylium norm mixed — after 8e: one batch of 10,000 after 100
             steps in memory at f64 and mixed, the norms within 2e-3, K3
             at complex64 on every block pair;
   HK / WM coumarin mixed — after 11: within 1e-4 / 1e-3 of the f64 runs,
             K4 at complex64 on every step (WM: K2 three times per step,
             K3 twice per batch), no complex128 launch;
   HK / WM methylium exact comp32 — after 6c: the first batch in memory
             with `integrator` "exact" at f64 and at comp32 (as the mixed
             phases): within 6e-4 / 1.5e-3, K1 at complex64 on every step,
             under WM K2 three times per step and K3 twice for the batch,
             no complex128 launch;
   HK / WM AS exact comp32 — after 8a: semi.json / semi_wm.json as
             shipped with `integrator` "exact" at comp32: the AS gates,
             within 6e-4 / 1.5e-3 of the HK / WM AS exact runs, the
             RK4-routed rows, K5 at float32 on every WM step and none at
             float64, the dtypes float32 q and qc, float32 Z, float64 S;
   HK AS exact f32 — 98,304 x 200 steps with `integrator` "exact" at f32
             and at f64: within 5e-2 / 1e-1, float32 q, Z and S;
R. the AS model's reduced-cost Hessian, at f64:
   HK / WM AS taylor — semi.json / semi_wm.json as shipped with
             `hessian_eval` "taylor" and `taylor_every` 8: the AS gates,
             the hessian_eval log line, max_t |C_taylor - C_stage| against
             the HK / WM AS runs within 10x the JAX package's own gap at
             the same draws (TAYLOR_STAGE_GAP_JAX, held by
             tests/test_torch_port_taylor_gap.py), K5 at float64 on every
             WM step, ms per step beside the stage run's;
   HK AS step — the first batch, 98,304 x 200 steps in memory with
             `hessian_eval` "step" and "stage": q, p and S within 1e-12 of
             the stage run's largest values (the JAX package's contract is
             bit for bit), the C(t) gap printed;
             each of these phases prints the precision line as P does;
G. the scale-out layer (`semiclassical_tpu_torch.parallel`), on this one
   card: NCCL refuses two ranks on one card, so groups of 2 and 4 ranks are
   held on gloo in the CPU tier (tests/test_torch_port_group.py), and no
   multi-GPU throughput is measured or claimed:
   HK methylium group — after 5: the HK methylium run as shipped through
             the CLI under a one-rank NCCL group (`--coordinator
             127.0.0.1:<free port> --num-processes 1 --process-id 0`): its
             npz within 1e-12 (of each curve's largest modulus) of the HK
             methylium phase's, the same K1 launches, the rate gate, the
             all-reduces of the run;
   WM AS group — after 8c: WM AS at 98,304 x 100 steps through the CLI
             under a one-rank group: C(t) and k~ic(t) within 1e-12 of the
             micro_batch phase's whole-batch run, K5 launched as often;
   ring norm — inside 8e: the WM methylium batch at t = 0 drawn under a
             one-rank group, its norm through the ring pair sum (K3 on
             every block pair of the rotation, counted) within 1e-12 of the
             blocked sum's, both timed in turns; then the all-reduce of a
             100-step methylium segment's sums, timed with CUDA events;
   accumulation mode — after the WM norm phases: two `dynamics` processes
             at once on the card with SEMI_PROCESS_ID 0 and 1 and no
             coordinator, methylium HK 10,000 x 500 with one manual_seed and
             `overwrite: true`, sharing one npz: each log shows the
             forced-overwrite warning, the npz counts 20,000 trajectories
             and equals the mean of the two ranks' batches run alone in
             this process within 1e-12, and those differ;
B. the flagship benches of `bench_torch.py` (the JAX package's bench.py
   configurations), after the coumarin phases:
   bench   — `bench_torch.run_benches` in this process at the card
             defaults (HK AS60 1,048,576 x 500 comp32, WM AS60 524,288 x
             500 comp32, sGDML coumarin 32,768 x 100 mixed with taylor
             every 32): every value finite
             and > 0, ntraj and nt as asked, |C(0) - 1| < 1e-3 on each
             curve, each scan through the warm-up's kept loop (0 captures,
             0 eager blocks, replays only), the coumarin bench again under
             `graph.eager()` within 1e-13 of the graph run's curves, K5 launched at (524,288, 60) float32 on every WM step
             and never at float64, K4 at (32,768, 45, 45) complex64 on
             every coumarin step and never at complex128 (the scan's
             launches counted with the graphs' replays; every call of the
             two wrappers, recorded by wrapping them, at that shape); the
             three JSON lines
             printed in bench.py's order; then the first 98,304 rows of the
             HK draw 200 steps at f64 and at comp32, within comp32's 6e-4 /
             1.5e-3; K5 on the WM bench's own planes and K4 at (32,768, 45,
             45) complex64 against their plain versions, timed beside the
             bound (and K4 beside torch.linalg.det);
   vr      — `scripts/torch_vr_flagship_bench.py` (the JAX package's
             scripts/vr_flagship_bench.py) at its defaults in this process:
             pseudo, sobol and antithetic sampling x 6 keys of 65,536 x 100
             on the AS60 model, HK comp32; its three lines; the 18 batches
             through one time loop (captures and eager blocks one per
             block length), finite variances, |C(0) - 1| < 1e-3 on every
             batch;
   pod bench — `scripts/torch_pod_bench.py` HK as a subprocess under a
             one-rank NCCL group at 131,072 x 100: its line (nchips 1,
             ntraj, nt, rates > 0, the card's name);
C. the compiled time loop (`propagation.graph`): every phase above runs
   the port's loop as it runs by default on the card, each scan segment as
   replays of captured CUDA graphs, and its launch checks count the
   replays' launches; then
   graph   — the first batch of each path in memory, drawn twice at the
             same seed, one run through the graphs and one under
             `graph.eager()` (every launch from the host): HK / WM
             methylium 10,000 x 500 (f64; HK exact; WM comp32), HK / WM AS
             98,304 x 100 (f64 with and without error bars; WM exact; HK
             exact comp32; HK and WM comp32), HK AS `hessian_eval` taylor
             every 8 x 96, WM AS `micro_batch` 8192 x 40, HK / WM coumarin
             2048 x 96 (taylor every 8), in segments of 100: C(t) and
             k~ic(t) of the two within GRAPH_GATE (1e-13) of the eager
             run's largest modulus (the difference printed), the launches
             of every kernel by dtype equal, the graphs replayed, and each
             run's ms a step (its whole `propagate`: the graph run's eager
             first blocks and captures included, their seconds printed);
             then the kept loop: HK AS exact 98,304 x 100, the first
             batch's draw and the same draw with its rows permuted (as many
             RK4-routed rows elsewhere) through one loop, the second with
             no capture and no eager block, each within 1e-13 of itself
             under `graph.eager()` on a fresh loop, launches equal;
   trace   — the port's tracing (`profiling`): the global timer's tick
             from TRACE_STAMPS stamp kernels back to back in one graph (at
             most TRACE_TICK_NS); then HK AS 98,304 x 105 (error bars) and
             HK coumarin 2048 x 96 (taylor every 8), each the first batch
             at seed SEED through one time loop: two warm-up runs capture
             each block length's graph and its twin (`trace_captures`
             equal to `captures`, one each a block length), then a run
             untraced and a run with tracing on, of the same draw, with no
             capture: C(t) and k~ic(t) equal bit for bit, the record's
             steps the run's, ms a step by section printed; the sections
             of 20 twin replays of a block within TRACE_EVENTS_GATE (2%)
             of CUDA events around them, the plain replays timed beside;
             one run under `torch.profiler`: no `semi.` name among its
             device operations, its stamp kernels counted;
12. the kernels' JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

TF32 stays off: the script fails if float32 matmuls would run in TF32
(checked at the start and again before the precision phases).
"""

import contextlib
import dataclasses
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
# max_t |C_exact(t) - C_rk4(t)| of the JAX package at float64 on the CPU,
# same draws, 256 trajectories x 2000 steps of 0.005 fs (recomputed and held
# to these values by tests/test_torch_port_exact_gap.py); the port's gap on
# the card is gated at EXACT_GAP_FACTOR times them
EXACT_RK4_GAP_JAX = {"HK methylium": 3.057e-13, "HK AS": 1.464e-11,
                     "WM AS": 1.458e-11}
EXACT_GAP_FACTOR = 10.0
# max_t |C_taylor(t) - C_stage(t)| of the JAX package at float64 on the CPU,
# same draws, the 60-mode AS model's hessian_eval "taylor" with taylor_every
# 8 against the 4-stage Hessian, 256 trajectories x 2000 steps of 0.005 fs in
# segments of 500 (recomputed and held to these values by
# tests/test_torch_port_taylor_gap.py); the port's gap on the card is gated
# at TAYLOR_GAP_FACTOR times them
TAYLOR_STAGE_GAP_JAX = {"HK AS": 3.423e-4, "WM AS": 3.409e-4}
TAYLOR_GAP_FACTOR = 10.0
# the coarse-grid run's (16x time_step_fs) closed-form rows against the
# full run's at the same time, relative to each field's largest value
COARSE_GATE = 1e-9
# the resumed checkpointed run against the uninterrupted one
RESUME_GATE = 1e-10
SEED = 1234
CELL_WIDTH = 10000.0
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
# float32 outside the tensor cores (NVIDIA's H100 SXM data sheet): the
# peak of the complex64 / float32 rows
FP32_FLOPS = 67e12
# the precision phases' gates against the f64 runs at the same draws, in
# units of the f64 curve's largest modulus: the JAX package's own (mixed:
# tests/test_precision.py, 1e-4 C(t) and 1e-3 k~ic(t); comp32: that plus
# tests/test_comp32.py's 5e-4 against mixed; f32: test_precision.py's
# 5e-2 and 1e-1)
PRECISION_GATES = {"mixed": (1e-4, 1e-3), "comp32": (6e-4, 1.5e-3),
                   "f32": (5e-2, 1e-1)}
# the WM norm in mixed precision against f64 (JAX test_precision.py)
NORM_MIXED_GATE = 2e-3
# the state's dtypes in the modes with float32 trajectories
EXPECT_DTYPES = {
    "comp32": {"q": "float32", "qc": "float32", "Z": "float32",
               "S": "float64"},
    "f32": {"q": "float32", "qc": None, "Z": "float32", "S": "float32"},
    "f64": {"q": "float64", "qc": None, "Z": "float64", "S": "float64"}}
# the "step" run's q, p and S against the "stage" run's, relative to each
# field's largest value: the JAX package's contract is bit for bit
STEP_GATE = 1e-12
# flops per (trajectory, mode) of K5, counted from csrc/wm_diag.cu
K5_FLOPS = 290
# operations per (trajectory, mode) of K6, counted from csrc/diag_mono.cu
# (negations included): 40 a seed, 12 for the row map
K6_FLOPS = 92
# K6's planes: Mqq .. Mpp and h1 .. h4 read, the four new planes written
K6_PLANES = 12
# (n, d, dtype name, case, limit kernel-vs-plain relative to the planes'
# largest entry). Cases: "whole" a (4, n, d) state; "view" the sub-batch
# Z[:, 8192:16384] of a (4, 98304, d) state, "view odd" Z[:, 1:1002];
# "aliased" one stage tensor four times; "broadcast" h1 one row expanded
# over the batch (the harmonic Morse model's Hessian)
K6_CASES = [
    (98304, 60, "float64", "whole", 1e-14),
    (98304, 60, "float32", "whole", 1e-5),
    (1, 60, "float64", "whole", 1e-14),
    (1, 60, "float32", "whole", 1e-5),
    (1001, 61, "float64", "whole", 1e-14),
    (1001, 61, "float32", "whole", 1e-5),
    (8192, 60, "float64", "view", 1e-14),
    (8192, 60, "float32", "view", 1e-5),
    (1001, 61, "float64", "view odd", 1e-14),
    (98304, 60, "float64", "aliased", 1e-14),
    (98304, 60, "float32", "aliased", 1e-5),
    (1001, 60, "float64", "broadcast", 1e-14),
]

# operations per (trajectory, mode) of K7, counted from csrc/morse_rk4.cu
# (negations included, the four exps not): 16 a stage, 12 for the stage
# arguments, 2 for k2 + k3, 10 for the RK4 sums of q and p
K7_FLOPS = 88
# K7's planes: q and p read, the new q and p and h1 .. h4 written; and its
# rows' numbers: S read, the new S and e1 written
K7_PLANES = 8
K7_ROW_NUMBERS = 3
# (n, d, dtype name, case, limit kernel-vs-plain on q, p, h1..h4 relative
# to each output's largest entry, the same on S and e1). Cases as
# K6_CASES: "whole" a (n, d) state; "view" the rows 8192:16384 of a (98304,
# d) state, "view odd" its rows 1:1002. q, p and h should agree bit for
# bit, S and e1 up to the order of the mode sums
K7_CASES = [
    (98304, 60, "float64", "whole", 0.0, 1e-14),
    (98304, 60, "float32", "whole", 0.0, 1e-5),
    (8192, 60, "float64", "view", 0.0, 1e-14),
    (8192, 60, "float32", "view", 0.0, 1e-5),
    (1001, 61, "float64", "view odd", 0.0, 1e-14),
    (1001, 61, "float32", "view odd", 0.0, 1e-5),
    (1001, 61, "float64", "whole", 0.0, 1e-14),
    (1001, 61, "float32", "whole", 0.0, 1e-5),
    (1, 60, "float64", "whole", 0.0, 1e-14),
    (1, 60, "float32", "whole", 0.0, 1e-5),
]

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
    # a batch that fills no whole block; at n = 1001 the planes of
    # `wm.wm_diag_inputs` on a WM state of the model's first d modes, Mqq ..
    # Mpp the views of one (4, n, d) tensor, not 16-byte aligned at odd n d
    # (and at float32 n d = 2 mod 4): the scalar variant
    (98305, 60, "float64", 1e-12),
    (98305, 60, "float32", 1e-5),
    (1001, 5, "float64", 1e-12),
    (1001, 5, "float32", 1e-5),
    (1001, 6, "float32", 1e-5),
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


def in_turns(kernel, plain, library, *args, others=None, plain_windows=None,
             library_windows=None):
    """Median per-call ms of the kernel, the plain version, the library
    call (None: not timed) and any `others` (name: callable), timed in
    turns: plain, library, others, kernel, kernel, others reversed,
    library, plain. `plain_windows` = (loops, calls) times the plain
    version in fewer and shorter windows than the rest, `library_windows`
    the library call."""
    import numpy as np
    fns = {"plain": plain, "library": library, **(others or {}),
           "kernel": kernel}
    short = {"plain": plain_windows, "library": library_windows}
    t = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        if fns[name] is not None:
            loops, calls = short.get(name) or (10, 20)
            t[name] += median_ms(fns[name], *args, loops=loops, calls=calls)
    med = {name: float(np.median(v)) if v else None for name, v in t.items()}
    return {"ms": med["kernel"], "plain_ms": med["plain"],
            "library_ms": med["library"], "windows": len(t["kernel"]),
            "plain_note": (f" ({len(t['plain'])} windows of "
                           f"{plain_windows[1]} calls)" if plain_windows
                           else ""),
            **{f"{name}_ms": med[name] for name in (others or {})}}


def bound(nbytes, flops, fp32=False):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the flops over the FP64 peak (the FP32 peak for complex64 / float32
    work: `fp32`)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (FP32_FLOPS if fp32 else FP64_FLOPS)
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
    # the reduced-precision modes' shape: complex64, the FP32 peak
    A64 = well_conditioned(n, r, torch.complex64, g)
    t64 = in_turns(det.batched_det, det.batched_det_lu_plain,
                   torch.linalg.det, A64)
    print(timing_line("K1", "(10000, 6, 6) complex64", t64,
                      *bound(n * (r * r + 1) * 8, lu_flops(n, r), True),
                      "torch.linalg.det"), flush=True)
    del A64
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
    A64 = well_conditioned(n, r, torch.complex64, g)
    t64 = in_turns(det_block.batched_det_block,
                   det_block.batched_det_lu_plain, torch.linalg.det, A64)
    print(timing_line("K4", "(2048, 45, 45) complex64", t64,
                      *bound(n * (r * r + 1) * 8, lu_flops(n, r), True),
                      "torch.linalg.det"), flush=True)
    del A64
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
    # the reduced-precision modes' shapes: complex64, the FP32 peak
    check_cases("K2", [(*leaf, "complex64", 1e-5, 1e-4)
                       for leaf in K2_LEAVES], run, oracle, None)
    for n, m, k in [(10000, 6, 12)] + K2_LEAVES:
        A = well_conditioned(n, m, torch.complex64, g)
        B = gaussian((n, m, k), torch.complex64, g)
        timed = in_turns(gj.batched_det_solve_gj,
                         gj.batched_det_solve_gj_plain, solve_library, A, B,
                         plain_windows=(3, 2) if m > 6 else None)
        print(timing_line("K2", f"({n}, {m}, {m} | {k}) complex64", timed,
                          *bound(n * (m * m + 2 * m * k + 1) * 8,
                                 gj_solve_flops(n, m, k), True),
                          "torch.linalg.solve + det"), flush=True)
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
        # the reduced-precision modes' shape: complex64, the FP32 peak
        A64 = well_conditioned(n, m, torch.complex64, g)
        t64 = in_turns(gj.batched_det_inv_gj, gj.batched_det_inv_gj_plain,
                       inv_library, A64)
        print(timing_line("K3", f"({n}, {m}, {m}) complex64", t64,
                          *bound(n * (2 * m * m + 1) * 8,
                                 gj_inv_flops(n, m), True),
                          "torch.linalg.inv_ex + det"), flush=True)
        del A64

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
    check_cases("K3 pair block", [(n, m, "complex64", 1e-5, 1e-4)], run,
                oracle, None)
    A = well_conditioned(n, m, torch.complex64, g)
    t64 = in_turns(gj.batched_det_inv_gj, gj.batched_det_inv_gj_plain,
                   inv_library, A, plain_windows=(3, 2))
    print(timing_line("K3", f"the WM norm's pair block ({b}^2 = {n}, {m}, "
                      f"{m}) complex64", t64,
                      *bound(n * (2 * m * m + 1) * 8, gj_inv_flops(n, m),
                             True), "torch.linalg.inv_ex + det"), flush=True)
    del A
    torch.cuda.empty_cache()
    return dict(timed, max_abs_err=main_abs_err, bound_ms=bnd[0],
                bound_by=bnd[1])


def reset_counts():
    """Set every kernel's launch count to 0."""
    from semiclassical_tpu_torch.ops import reset_launch_counts
    reset_launch_counts()


def read_counts(by_dtype=False):
    """Each kernel's launches since `reset_counts`, by its label
    (`ops.launch_counts()`): in all, or by the dtype it ran at."""
    from semiclassical_tpu_torch.ops import launch_counts
    counts = launch_counts()
    return counts if by_dtype else {k: sum(n.values())
                                    for k, n in counts.items()}


# the launches by dtype, and the time loop's counters (`graph.STATS`), of
# the last dynamics command `run_path` ran
LAST_BY_DTYPE = {}
LAST_LOOP = {}


def run_path(cli, ops, config, dynamics_keys, tmp, precision="f64",
             extra_args=()):
    """Run `config`'s dynamics task (updated with `dynamics_keys`) at
    `--precision precision` (and the CLI flags `extra_args`), then its
    rates and spectrum tasks, through the
    port's CLI on cuda, writing into `tmp`; every launch count is set to 0
    just before the dynamics command and read just after (the counts by
    dtype into LAST_BY_DTYPE). Returns (the npz as a dict, the launches,
    the dynamics task, the dynamics command's wall seconds, the port's log
    lines of the dynamics command); the command's time loop counters
    (`graph.STATS`) go into LAST_LOOP."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch.propagation import graph

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

    reset_counts()
    stats = dict(graph.STATS)
    t0 = time.perf_counter()
    with LogLines() as log:
        rc = cli.main(["dynamics", cfg, "--device", "cuda", "--precision",
                       precision, *extra_args])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    LAST_BY_DTYPE.clear()
    LAST_BY_DTYPE.update(read_counts(by_dtype=True))
    LAST_LOOP.clear()
    LAST_LOOP.update({k: graph.STATS[k] - stats[k] for k in stats})
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


def methylium_run(cli, ops, smi, label, precision="f64", extra_args=(),
                  **task_keys):
    """examples/methylium_AH at its own size through the port's CLI on
    cuda at `precision` (with the CLI flags `extra_args`), with `task_keys`
    set on the dynamics task. Returns (the rates npz as a dict, the
    kernels' launches during the dynamics command)."""
    with open(EXAMPLE) as f:
        config = json.load(f)
    for task in config["semi"]:
        if task["task"] == "dynamics":
            for key in ("ground", "excited", "coupling"):
                task["potential"][key] = str(
                    (EXAMPLE.parent / task["potential"][key]).resolve())
    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall, _ = run_path(cli, ops, config,
                                                 task_keys, tmp, precision,
                                                 extra_args)
    nsteps, ntraj = task["num_steps"], task["num_trajectories"]
    nrep = ntraj // task["batch_size"]
    print(f"{label} methylium {ntraj} x {nsteps} steps ({nrep} batches): "
          f"dynamics command {wall:.3f} s wall, "
          f"{ntraj * nsteps / wall:.0f} traj-steps/s [{smi}]; launches "
          f"{json.dumps(launches)}", flush=True)
    imax = gate_rates(f"{label} methylium", data, REFERENCE_RATE, ntraj,
                      nsteps, 1e-3)
    kept_loop_check(f"{label} methylium", nsteps, 100, nrep)
    check(launches["K1"] >= nsteps * nrep,
          f"{label}: K1 launched {launches['K1']} times for {nsteps} x "
          f"{nrep} steps")
    data.update(imax=imax, nsteps=nsteps, nrep=nrep, wall=wall, task=task)
    return data, launches


def block_lengths_of(nsteps, chunk, window=1):
    """The distinct block lengths of a run of `nsteps` steps in segments of
    `chunk` (`graph.block_lengths` of each segment)."""
    from semiclassical_tpu_torch.propagation import graph

    segments = [chunk] * (nsteps // chunk) + ([nsteps % chunk]
                                              if nsteps % chunk else [])
    return {n for seg in segments for n in graph.block_lengths(seg, window)}


def kept_loop_check(label, nsteps, chunk, nrep):
    """The last dynamics command's time loop (LAST_LOOP) over its `nrep`
    batches: one capture and one eager block per block length for the whole
    run, every batch after the first replaying its graphs."""
    lengths = block_lengths_of(nsteps, chunk)
    print(f"{label}: time loop over {nrep} batches: {LAST_LOOP['captures']}"
          f" captures in {LAST_LOOP['capture_s']:.3f} s, "
          f"{LAST_LOOP['eager_blocks']} eager blocks, "
          f"{LAST_LOOP['replays']} replays; {len(lengths)} block length(s) "
          f"{sorted(lengths)}", flush=True)
    check(LAST_LOOP["captures"] == LAST_LOOP["eager_blocks"] == len(lengths),
          f"{label}: {LAST_LOOP} for the block lengths {sorted(lengths)}")


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
    return wm, launches


def write_as_model(tmp):
    """examples/as_model/make_model.py's 60-mode model (rng seed 42, chi
    0.02) as AS_model.dat in `tmp`."""
    model = pathlib.Path(tmp) / "AS_model.dat"
    with open(model, "w") as f:
        subprocess.run([sys.executable, str(AS_EXAMPLE / "make_model.py")],
                       stdout=f, check=True, timeout=120)
    return str(model)


def as_config(file, model, potential_keys=None, **dynamics_keys):
    """examples/as_model/`file` with its model file at `model`,
    `potential_keys` set on its potential and `dynamics_keys` on the
    dynamics task."""
    with open(AS_EXAMPLE / file) as f:
        config = json.load(f)
    for task in config["semi"]:
        if task["task"] == "dynamics":
            task["potential"].update(potential_keys or {}, model_file=model)
            task.update(dynamics_keys)
    return config


def as_run(cli, ops, smi, model, label, file, precision="f64",
           potential_keys=None, **dynamics_keys):
    """examples/as_model/`file` as shipped (with `potential_keys` set on its
    potential and `dynamics_keys` on its dynamics task), at its own size,
    through the port's CLI on cuda at `precision`; the error-bar and
    spectrum gates where the file asks for them."""
    import numpy as np

    config = as_config(file, model, potential_keys, **dynamics_keys)
    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall, lines = run_path(cli, ops, config, {},
                                                     tmp, precision)
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
    data.update(imax=imax, nsteps=nsteps, nrep=nrep, wall=wall, lines=lines,
                task=task)
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
    """The WM AS example at 98,304 x 100 steps with micro_batch 8192
    against the whole batch at the same seed."""
    import numpy as np

    runs, loops = {}, {}
    for micro in (0, 8192):
        with tempfile.TemporaryDirectory() as tmp:
            data, launches, _, wall, _ = run_path(
                cli, ops, as_config("semi_wm.json", model, num_steps=100,
                                    micro_batch=micro), {}, tmp)
        runs[micro] = (data, launches, wall)
        loops[micro] = dict(LAST_LOOP)
    errs = [float(np.abs(runs[8192][0][k] - runs[0][0][k]).max()
                  / np.abs(runs[0][0][k]).max())
            for k in ("autocorrelation", "ic_correlation")]
    print(f"micro_batch: WM AS 98304 x 100 steps, dynamics command "
          f"{runs[0][2]:.3f} s whole ({runs[0][1]['K5']} K5 launches), "
          f"{runs[8192][2]:.3f} s in sub-batches of 8192 "
          f"({runs[8192][1]['K5']} K5 launches) [{smi}]; max |C - C_whole| /"
          f" max |C_whole| {errs[0]:.3e}, k~ic {errs[1]:.3e} (gate 1e-12); "
          f"time loop in sub-batches: {loops[8192]['captures']} captures in "
          f"{loops[8192]['capture_s']:.3f} s, {loops[8192]['eager_blocks']} "
          f"eager blocks, {loops[8192]['replays']} replays (whole batch: "
          f"{loops[0]['captures']} in {loops[0]['capture_s']:.3f} s)",
          flush=True)
    check(max(errs) <= 1e-12, f"micro_batch vs whole batch: {errs}")
    check(loops[8192]["captures"] <= 2,
          f"micro_batch: {loops[8192]['captures']} captures; the sub-batches "
          "share one graph per block length")
    return runs[0]


# NCCL refuses two ranks on one card, so groups of 2 and 4 ranks are held
# on gloo in the CPU tier (tests/test_torch_port_group.py); one card cannot
# measure multi-GPU throughput, and nothing here claims it.
GROUP_GATE = 1e-12


def free_port():
    """A free TCP port on the loopback interface, for a group's store."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def group_args():
    """The CLI flags of a one-rank NCCL group on this card."""
    return ["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
            "1", "--process-id", "0"]


def curve_gap(x, ref):
    """max |x - ref| / max |ref| of two curves."""
    import numpy as np

    return float(np.abs(np.asarray(x) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


class TimedReduces:
    """Wraps the propagators' `group_sum` (`propagation.hk.group_sum`: the
    batch set-up's and every segment end's all-reduce) while active,
    recording each call's seconds between two synchronisations of the
    card (the work queued before it is finished first)."""

    def __enter__(self):
        import torch

        from semiclassical_tpu_torch.propagation import hk

        self.hk, self.orig, self.calls = hk, hk.group_sum, []

        def timed(tensors, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(tensors, group)
            torch.cuda.synchronize()
            self.calls.append(time.perf_counter() - t0)
            return out

        hk.group_sum = timed
        return self

    def __exit__(self, *exc):
        self.hk.group_sum = self.orig

    def line(self):
        total = sum(self.calls)
        return (f"{len(self.calls)} all-reduces of the propagator, "
                f"{1e3 * total:.3f} ms in all, "
                f"{1e6 * total / max(len(self.calls), 1):.1f} us each")


def group_methylium_phase(cli, ops, smi, hk, hk_launches):
    """HK methylium as shipped through the CLI under a one-rank NCCL group
    (--coordinator): the npz within GROUP_GATE of the HK methylium phase's,
    the same K1 launches, the rate gate, and the all-reduces of the run."""
    from semiclassical_tpu_torch.parallel import group as counter

    counter.ALL_REDUCES = 0
    with TimedReduces() as timed:
        data, launches = methylium_run(cli, ops, smi, "HK group",
                                       extra_args=group_args())
    reduces = counter.ALL_REDUCES
    gaps = [curve_gap(data[k], hk[k])
            for k in ("autocorrelation", "ic_correlation")]
    print(f"HK methylium, 1-rank NCCL group: {data['wall']:.3f} s wall "
          f"against {hk['wall']:.3f} s alone [{smi}]; C(t) and k~ic(t) "
          f"{gaps[0]:.3e}, {gaps[1]:.3e} of their largest modulus from the "
          f"HK methylium npz (gate {GROUP_GATE:g}); K1 launches "
          f"{launches['K1']} (alone {hk_launches['K1']}); all-reduces "
          f"{reduces} ({reduces / data['nrep']:.0f} per batch of "
          f"{data['nsteps']} steps); {timed.line()}", flush=True)
    check(max(gaps) <= GROUP_GATE, f"HK methylium group vs alone: {gaps}")
    check(launches["K1"] == hk_launches["K1"],
          f"HK methylium group: K1 {launches['K1']} vs {hk_launches['K1']}")
    check(reduces > 0, "HK methylium group: no all-reduce ran")


def group_as_wm_phase(cli, ops, smi, model, plain):
    """WM AS at 98,304 x 100 steps through the CLI under a one-rank NCCL
    group: C(t) and k~ic(t) within GROUP_GATE of the run alone (`plain`:
    the micro_batch phase's whole batch), K5 on every step."""
    from semiclassical_tpu_torch.parallel import group as counter

    counter.ALL_REDUCES = 0
    with tempfile.TemporaryDirectory() as tmp, TimedReduces() as timed:
        data, launches, _, wall, _ = run_path(
            cli, ops, as_config("semi_wm.json", model, num_steps=100), {},
            tmp, extra_args=group_args())
    reduces = counter.ALL_REDUCES
    ref, ref_launches, ref_wall = plain
    gaps = [curve_gap(data[k], ref[k])
            for k in ("autocorrelation", "ic_correlation")]
    print(f"WM AS 98304 x 100 steps, 1-rank NCCL group: dynamics command "
          f"{wall:.3f} s against {ref_wall:.3f} s alone [{smi}]; C(t) and "
          f"k~ic(t) {gaps[0]:.3e}, {gaps[1]:.3e} of their largest modulus "
          f"from the run alone (gate {GROUP_GATE:g}); K5 launches "
          f"{launches['K5']} (alone {ref_launches['K5']}); all-reduces "
          f"{reduces}; {timed.line()}", flush=True)
    check(max(gaps) <= GROUP_GATE, f"WM AS group vs alone: {gaps}")
    check(launches["K5"] >= 100 and launches["K5"] == ref_launches["K5"],
          f"WM AS group: K5 {launches['K5']} vs {ref_launches['K5']}")


def ring_norm_phase(cli, smi, task, prop, exact):
    """The WM methylium batch at t = 0 under a one-rank NCCL group: its
    norm through the ring (K3 on every block pair of the rotation) against
    the single process's blocked sum (`exact`, of `prop`) within
    GROUP_GATE, both timed; then the all-reduce of a methylium scan
    segment's sums (100 steps: C, k~ic, energies), timed."""
    import torch

    from semiclassical_tpu_torch.parallel import (destroy_group, group_sum,
                                                  init_group)
    from semiclassical_tpu_torch.propagation import (
        WaltonManolopoulosPropagator, hk, wm)

    group = init_group(f"127.0.0.1:{free_port()}", 1, 0, "cuda",
                       timeout=300.0)
    try:
        gprop = first_batch(cli, task, WaltonManolopoulosPropagator,
                            CELL_WIDTH, CELL_WIDTH, group=group)
        n, d, r = gprop.n_local, gprop.params.dim, gprop.params.rank
        block = hk.pair_block(n, wm.wm_pair_bytes(d, r), "cuda")
        nb = hk._ring_block_count(n, block)
        walls = {}
        for name, p in (("blocked", prop), ("ring", gprop),
                        ("ring ", gprop), ("blocked ", prop)):
            before = read_counts()["K3"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = p.norm()
            torch.cuda.synchronize()
            walls.setdefault(name.strip(), []).append(
                (time.perf_counter() - t0, read_counts()["K3"] - before,
                 value))
        ring = walls["ring"][0][2]
        rel = abs(ring - exact) / abs(exact)
        segment = [torch.zeros(1, 100, dtype=torch.complex128, device="cuda"),
                   torch.zeros(1, 100, dtype=torch.complex128, device="cuda"),
                   torch.zeros(1, 100, dtype=torch.float64, device="cuda")]
        for _ in range(10):
            group_sum(segment, group)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        calls = 200
        start.record()
        for _ in range(calls):
            group_sum(segment, group)
        end.record()
        torch.cuda.synchronize()
        reduce_us = 1e3 * start.elapsed_time(end) / calls
    finally:
        destroy_group(group)
    fmt = lambda runs: ", ".join(f"{w:.3f} s ({k} K3)" for w, k, _ in runs)
    print(f"WM methylium norm at t = 0 through the ring, 1-rank NCCL group: "
          f"{ring:.12f} against the blocked sum's {exact:.12f}: rel dev "
          f"{rel:.3e} (gate {GROUP_GATE:g}); {nb} x {nb} block pairs of "
          f"{n // nb}; ring {fmt(walls['ring'])}, blocked "
          f"{fmt(walls['blocked'])} [{smi}]", flush=True)
    print(f"all-reduce of a 100-step methylium segment's sums (C, k~ic "
          f"complex128, energies float64: 500 float64), 1-rank NCCL group: "
          f"{reduce_us:.1f} us per call over {calls} calls, packing "
          f"included [{smi}]", flush=True)
    check(rel <= GROUP_GATE, f"WM ring norm vs blocked: {rel}")
    check(all(k >= nb * nb for _, k, _ in walls["ring"]),
          f"WM ring norm: K3 launched {walls['ring']} for {nb * nb} pairs")


def accumulation_phase(cli, smi):
    """Two accumulation-mode `dynamics` processes at once on this card
    (SEMI_PROCESS_ID 0 and 1, no coordinator), methylium HK 10,000 x 500
    with one manual_seed and `overwrite: true`, sharing one npz: each log
    shows the forced-overwrite warning, the npz counts 20,000
    trajectories, and it is the equal-weight merge of each rank's batch
    run alone in this process (SEMI_PROCESS_ID 0, then 1), whose C(t)
    differ."""
    import os

    import numpy as np

    with open(EXAMPLE) as f:
        config = json.load(f)
    task = next(t for t in config["semi"] if t["task"] == "dynamics")
    for key in ("ground", "excited", "coupling"):
        task["potential"][key] = str(
            (EXAMPLE.parent / task["potential"][key]).resolve())
    task.update(batch_size=10000, num_trajectories=10000, num_steps=500,
                manual_seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        def write(name):
            task["results"] = {"correlations": str(pathlib.Path(tmp)
                                                   / f"{name}.npz"),
                               "overwrite": True}
            cfg = pathlib.Path(tmp) / f"{name}.json"
            cfg.write_text(json.dumps({"semi": [task]}))
            return str(cfg)

        shared = write("shared")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "semiclassical_tpu_torch.cli", "dynamics",
             shared, "--device", "cuda"],
            env=dict(env, SEMI_PROCESS_ID=str(rank)), cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in (0, 1)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        wall = time.perf_counter() - t0
        for rank, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0,
                  f"accumulation rank {rank} exited {p.returncode}: "
                  f"{log[-2000:]}")
            check("results.overwrite forced to false" in log,
                  f"accumulation rank {rank}: no forced-overwrite warning")
        data = dict(np.load(pathlib.Path(tmp) / "shared.npz"))
        own = []
        t1 = time.perf_counter()
        for rank in (0, 1):
            os.environ["SEMI_PROCESS_ID"] = str(rank)
            try:
                check(cli.main(["dynamics", write(f"own{rank}"), "--device",
                                "cuda"]) == 0, f"lone rank {rank} failed")
            finally:
                del os.environ["SEMI_PROCESS_ID"]
            own.append(dict(np.load(pathlib.Path(tmp) / f"own{rank}.npz")))
        lone = time.perf_counter() - t1
    gaps = [curve_gap(data[k], 0.5 * (own[0][k] + own[1][k]))
            for k in ("autocorrelation", "ic_correlation")]
    apart = curve_gap(own[1]["ic_correlation"], own[0]["ic_correlation"])
    print(f"accumulation mode: two methylium HK processes 10000 x 500 at "
          f"once on one card, {wall:.3f} s wall for both (the two lone runs "
          f"in this process {lone:.3f} s) [{smi}]; npz "
          f"{int(data['trajectories'])} trajectories; against the mean of "
          f"the lone runs of rank 0 and 1: C(t) {gaps[0]:.3e}, k~ic(t) "
          f"{gaps[1]:.3e} (gate {GROUP_GATE:g}); rank 1's k~ic(t) differs "
          f"from rank 0's by {apart:.3e} of its largest modulus", flush=True)
    check(int(data["trajectories"]) == 20000,
          f"accumulation: {data['trajectories']} trajectories")
    check(max(gaps) <= GROUP_GATE, f"accumulation merge vs lone runs: {gaps}")
    check(apart > 1e-6, f"accumulation: the ranks drew one batch ({apart})")


def exact_gap(label, exact, rk4):
    """The exact run's C(t) against the RK4 run's at the same seed: the
    largest gap, gated at EXACT_GAP_FACTOR x the JAX package's own."""
    import numpy as np

    gap = float(np.abs(exact["autocorrelation"]
                       - rk4["autocorrelation"]).max())
    gate = EXACT_GAP_FACTOR * EXACT_RK4_GAP_JAX[label]
    print(f"{label} exact vs RK4 at seed {SEED}: max_t |C_exact - C_rk4| = "
          f"{gap:.3e} (gate {gate:.3e}: {EXACT_GAP_FACTOR:g}x the JAX "
          f"package's {EXACT_RK4_GAP_JAX[label]:.3e})", flush=True)
    check(gap < gate, f"{label} exact vs RK4 gap {gap:.3e} >= {gate:.3e}")


def per_step(label, exact, ex_launches, rk4, rk4_launches, smi):
    """ms per step (the dynamics command's wall over its steps) and each
    kernel's launches per step, exact beside RK4."""
    steps = exact["nsteps"] * exact["nrep"]
    fmt = lambda launches: ", ".join(f"{k} {v / steps:.3f}"
                                     for k, v in launches.items() if v)
    print(f"{label} per step: exact {1e3 * exact['wall'] / steps:.4f} ms "
          f"(launches per step: {fmt(ex_launches) or 'none'}), RK4 "
          f"{1e3 * rk4['wall'] / steps:.4f} ms (launches per step: "
          f"{fmt(rk4_launches) or 'none'}) [{smi}]", flush=True)


def exact_methylium_phase(cli, ops, smi, hk, hk_launches):
    """The HK methylium run with integrator "exact" at the RK4 phase's seed
    and size: its gates, the gap to the RK4 run, K1 on every step."""
    ex, launches = methylium_run(cli, ops, smi, "HK exact",
                                 integrator="exact")
    exact_gap("HK methylium", ex, hk)
    per_step("HK methylium", ex, launches, hk, hk_launches, smi)
    return ex


def exact_wm_methylium_phase(cli, ops, smi, hk_ex, wm, wm_launches):
    """WM methylium with integrator "exact" at the HK exact phase's seed
    and size, held against it; K2 three times per step."""
    ex, launches = methylium_run(cli, ops, smi, "WM exact", propagator="WM",
                                 cell_width=CELL_WIDTH, integrator="exact")
    wm_vs_hk("methylium exact", ex, hk_ex, WM_HK_GATE)
    steps = ex["nsteps"] * ex["nrep"]
    check(launches["K2"] >= 3 * steps,
          f"WM exact: K2 launched {launches['K2']} times for {steps} steps")
    per_step("WM methylium", ex, launches, wm, wm_launches, smi)


def routed_rows(lines):
    """The RK4-routed rows the exact Morse map logged (0 when none)."""
    for line in lines:
        if line.startswith("exact Morse map:"):
            return line.split(":")[1].split()[0]
    return "0/all"


def exact_as_phase(cli, ops, smi, model, label, file, rk4, rk4_launches):
    """The AS example `file` as shipped plus integrator "exact": its gates,
    the gap to the RK4 run at the same seed, the routed rows."""
    ex, launches = as_run(cli, ops, smi, model, f"{label} exact", file,
                          integrator="exact")
    print(f"{label} AS exact: RK4-routed rows {routed_rows(ex['lines'])}",
          flush=True)
    exact_gap(f"{label} AS", ex, rk4)
    per_step(f"{label} AS", ex, launches, rk4, rk4_launches, smi)
    if label == "WM":
        steps = ex["nsteps"] * ex["nrep"]
        check(launches["K5"] >= steps,
              f"WM AS exact: K5 launched {launches['K5']} times for {steps} "
              "steps")
    return ex


def coarse_phase(cli, ops, smi, model, full):
    """HK AS exact at 16 x time_step_fs and 2000 / 16 steps. The CLI run's
    C(t) against every 16th point of the full exact run is printed: the
    RK4-routed rows step by RK4 at the coarse step, and at 16x the step
    the branch tracking of sqrt(C^2) misses crossings of some trajectories,
    so C(t) moves well beyond rounding. The map itself is gated: the first
    batch in memory, fine and coarse, whose closed-form rows must reach one
    state at t = 2000 dt (q, p, S, the monodromy planes and C^2) to
    COARSE_GATE of each field's largest value."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import HermanKlukPropagator

    config = as_config("semi.json", model, integrator="exact")
    task = config["semi"][0]
    task.update(time_step_fs=16 * task["time_step_fs"],
                num_steps=task["num_steps"] // 16)
    with tempfile.TemporaryDirectory() as tmp:
        data, _, task, wall, lines = run_path(cli, ops, config, {}, tmp)
    errs = [float(np.abs(data[k] - full[k][::16]).max()
                  / np.abs(full[k]).max())
            for k in ("autocorrelation", "ic_correlation")]
    print(f"AS exact coarse dt: HK {task['batch_size']} x "
          f"{task['num_steps']} steps of {task['time_step_fs']} fs, dynamics "
          f"command {wall:.3f} s [{smi}], RK4-routed rows "
          f"{routed_rows(lines)}; against every 16th point of the full run: "
          f"C(t) {errs[0]:.3e}, k~ic(t) {errs[1]:.3e} of their largest "
          "modulus", flush=True)

    dyn = as_config("semi.json", model)["semi"][0]
    potential, q0, _, G, zpe, _, _ = cli._build_potential(dyn, "cuda")
    dt = dyn["time_step_fs"] / units.autime_to_fs
    props = []
    for mult in (1, 16):
        prop = HermanKlukPropagator(G, G, device="cuda", integrator="exact")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cli._repetition_seed(SEED, 0))
        prop.initial_conditions(q0, 0 * q0, G, potential,
                                ntraj=dyn["batch_size"], generator=gen)
        prop.propagate(potential, mult * dt, dyn["num_steps"] // mult,
                       energy0_es=zpe, chunk=500)
        prop.semiclassical_prefactor()     # the trackers at t = 2000 dt
        props.append(prop)
    fine, coarse = props
    bound = torch.ones(fine.ntraj, dtype=torch.bool, device="cuda")
    if fine._morse.pack.sub_idx is not None:
        bound[fine._morse.pack.sub_idx] = False
    fields = {name: (getattr(coarse.state, name), getattr(fine.state, name))
              for name in ("q", "p", "S")}
    fields["Z"] = (coarse.state.Z[:, bound], fine.state.Z[:, bound])
    fields["C^2"] = (coarse.tracker.previous, fine.tracker.previous)
    errs = {name: float((c if name == "Z" else c[bound])
                        .sub(f if name == "Z" else f[bound]).abs().max()
                        / (f if name == "Z" else f[bound]).abs().max())
            for name, (c, f) in fields.items()}
    flips = int(((coarse.tracker.signs != fine.tracker.signs) & bound).sum())
    print(f"AS exact coarse dt, the map: {int(bound.sum())} closed-form rows "
          f"at t = 2000 dt, coarse vs fine "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" of the largest value (gate {COARSE_GATE:g}); branch signs of "
          f"sqrt(C^2) differ on {flips} of them", flush=True)
    check(max(errs.values()) < COARSE_GATE,
          f"coarse-dt state of the closed-form rows off by {errs}")


class Killed(Exception):
    """Raised from the progress callback to kill a checkpointed run."""


def checkpoint_phase(cli, ops, smi, model, full):
    """HK AS exact with `checkpoint` and `checkpoint_every` 500, killed
    from the progress callback after its second segment, then resumed in
    this process: the npz equals the uninterrupted run's to RESUME_GATE."""
    import numpy as np

    from semiclassical_tpu_torch import checkpoint

    writes = []
    kill = {"on": True}
    real_save, real_init = (checkpoint.save_propagator_state,
                            checkpoint.CheckpointedRun.__init__)

    def timed_save(filename, propagator, partial=None):
        t0 = time.perf_counter()
        real_save(filename, propagator, partial)
        writes.append((time.perf_counter() - t0,
                       pathlib.Path(filename).stat().st_size))

    def init(run, *args, **kwargs):
        real_init(run, *args, **kwargs)
        progress = run.progress

        def killing(done, nt, c_last):
            progress(done, nt, c_last)
            if kill["on"] and done >= 2 * run.segment:
                raise Killed(done)

        run.progress = killing

    checkpoint.save_propagator_state = timed_save
    checkpoint.CheckpointedRun.__init__ = init
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = str(pathlib.Path(tmp) / "run.ckpt.npz")
            config = as_config("semi.json", model, integrator="exact",
                               checkpoint=ckpt, checkpoint_every=500)
            t0 = time.perf_counter()
            try:
                run_path(cli, ops, config, {}, tmp)
                check(False, "checkpoint: the run was not killed")
            except Killed as done:
                killed_at = int(str(done))
            killed_wall = time.perf_counter() - t0
            meta = checkpoint.peek_checkpoint(ckpt)
            check(int(meta["steps_done"]) == killed_at == 1000,
                  f"checkpoint: killed at {killed_at}, the file at "
                  f"{int(meta['steps_done'])}")
            kill["on"] = False
            data, _, _, wall, lines = run_path(cli, ops, config, {}, tmp)
            check(not pathlib.Path(ckpt).exists(),
                  "checkpoint: the file survived the finished run")
    finally:
        checkpoint.save_propagator_state = real_save
        checkpoint.CheckpointedRun.__init__ = real_init
    check(any("resuming" in line for line in lines),
          "checkpoint: the second run did not resume")
    errs = {k: float(np.abs(data[k] - full[k]).max() / np.abs(full[k]).max())
            for k in ("autocorrelation", "ic_correlation",
                      "autocorrelation_stderr", "ic_correlation_stderr")}
    secs = [w[0] for w in writes]
    print(f"checkpoint: HK AS exact, checkpoint_every 500, killed at step "
          f"{killed_at} after {killed_wall:.3f} s, resumed in {wall:.3f} s "
          f"[{smi}]; {len(writes)} writes of {writes[0][1] / 1e6:.1f} MB, "
          f"{min(secs):.3f}-{max(secs):.3f} s each; resumed vs uninterrupted "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" of their largest value (gate {RESUME_GATE:g})", flush=True)
    check(max(errs.values()) < RESUME_GATE,
          f"checkpoint: the resumed run is off by {errs}")


class NormCalls:
    """Wraps a propagator class's `norm` while active, recording each
    call's wall seconds and K3 launches."""

    def __init__(self, cls):
        self.cls, self.calls = cls, []

    def __enter__(self):
        import torch
        orig = self.orig = self.cls.norm

        def norm(prop, *args, **kwargs):
            before = read_counts()["K3"]
            t0 = time.perf_counter()
            out = orig(prop, *args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0,
                               read_counts()["K3"] - before))
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


def first_batch(cli, task, cls, *args, precision="f64",
                with_potential=False, group=None):
    """The first repetition's batch of `task` at t = 0, drawn as the CLI
    draws it at seed SEED, at `precision` (the potential in the mode's
    form, as the CLI builds it) with the task's integrator, under the
    process `group` if given; with `with_potential`, (the propagator, that
    potential)."""
    import torch

    potential, q0, p0, G, _, _, _ = cli._build_potential(task, "cuda")
    dtype, traj_dtype = cli._precision_dtypes(precision)
    potential = cli._reduced_potential(potential, dtype)
    prop = cls(G, G, *args, device="cuda", dtype=dtype,
               traj_dtype=traj_dtype,
               integrator=task.get("integrator", "rk4"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cli._repetition_seed(SEED, 0))
    prop.initial_conditions(q0, p0, G, potential,
                            ntraj=min(task["batch_size"],
                                      task["num_trajectories"]),
                            generator=gen, group=group)
    return (prop, potential) if with_potential else prop


def hk_norm_phase(cli, ops, smi, model):
    """examples/as_model/semi_norm.json as shipped, and its first batch
    at t = 0 in memory."""
    import numpy as np

    from semiclassical_tpu_torch.propagation import HermanKlukPropagator, hk

    config = as_config("semi_norm.json", model)
    with tempfile.TemporaryDirectory() as tmp, \
            NormCalls(HermanKlukPropagator) as calls:
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
            NormCalls(WaltonManolopoulosPropagator) as calls:
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
    del derived, arrays
    ring_norm_phase(cli, smi, task, prop, exact)
    del prop
    torch.cuda.empty_cache()
    return launches, dict(block=block, n=n, d=d, r=r)


def kernel_ptxas(build_log, kernel, label):
    """The lines of ptxas' report (registers and spills) of the
    instantiations of `kernel` (a name in the mangled entry) from the
    build's log, two per instantiation; fails if one spills."""
    entry, lines = None, []
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if kernel in line else None
        elif entry and ("spill" in line or "Used" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
            if "spill" in line:
                check("0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{label} spills: {entry}: {line.strip()}")
    return lines


def k5_planes_few_modes(cli, model, d):
    """K5's inputs from `wm.wm_diag_inputs` on a WM state of the first d
    modes of the AS model after 10 steps at n = 1001, the main path's own
    planes: Mqq .. Mpp the views of the state's (4, n, d) Z; at float32 the
    views of Z cast as one tensor, as the reduced modes cast it."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.potentials import MorsePotential
    from semiclassical_tpu_torch.propagation import (
        WaltonManolopoulosPropagator, wm)

    task = {"potential": {"type": "anharmonic AS", "model_file": model}}
    potential, q0, _, G, _, _, _ = cli._build_potential(task, "cuda")
    sub = lambda x: x[:d].cpu().numpy()
    pot = MorsePotential.from_arrays(sub(potential.omega), sub(potential.a),
                                     sub(potential.D), sub(potential.nac),
                                     False, "cuda")
    Gd, qd = G[:d, :d], q0[:d]
    prop = WaltonManolopoulosPropagator(Gd, Gd, CELL_WIDTH, CELL_WIDTH,
                                        device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 6)
    prop.initial_conditions(qd, 0 * qd, Gd, pot, ntraj=1001, generator=g)
    prop._run(pot, 0.005 / units.autime_to_fs, 10)
    planes, _ = wm.wm_diag_inputs(prop.params, prop.bc, prop.state, pot)
    pack = prop.params.diag_pack
    z32 = prop.state.Z.to(torch.float32)
    return {"float64": (list(planes), pack),
            "float32": ([*z32, *(x.float() for x in planes[4:])],
                        pack.float())}


def k5_phase(cli, wm_diag, model):
    """K5 against its plain version on a WM state of the 60-mode AS
    example after 10 steps (and on the main path's planes of 5- and 6-mode
    states at n = 1001, misaligned), its times at (98304, 60) float64 and
    float32, and ptxas' report of its instantiations."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.ops import _build
    from semiclassical_tpu_torch.propagation import (
        WaltonManolopoulosPropagator, wm)

    for line in kernel_ptxas(_build.build_log(), "wm_diag_kernel", "K5"):
        print(f"K5 ptxas: {line}", flush=True)
    task = {"potential": {"type": "anharmonic AS", "model_file": model}}
    potential, q0, _, G, _, _, _ = cli._build_potential(task, "cuda")
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
    few = {d: k5_planes_few_modes(cli, model, d) for d in (5, 6)}

    def row_err(got, ref, dims):
        """Largest error per output row relative to the row's largest
        entry (absolute for a row of zeros: the p0 sums at p0 = 0)."""
        scale = ref.abs().amax(dim=dims)
        return float(((got - ref).abs().amax(dim=dims)
                      / torch.where(scale > 0, scale, 1.0)).max())

    def case_inputs(n, d, dname):
        dtype = getattr(torch, dname)
        if n == 1001:
            return few[d][dname]
        # rows past the state's repeat its first ones
        src = [torch.cat([x, x[:n - x.shape[0]]]) if n > x.shape[0] else x
               for x in planes]
        return ([x[:n, :d].to(dtype).contiguous() for x in src],
                pack[:, :d].to(dtype).contiguous())

    main_abs_err = None
    for n, d, dname, lim in K5_CASES:
        args, cpack = case_inputs(n, d, dname)
        variant = wm_diag.layout_of(args).variant
        scal_k, det_k = wm_diag.wm_diag_derived(*args, cpack)
        scal_p, det_p = wm_diag.wm_diag_derived_plain(*args, cpack)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(scal_k).all()
                      and torch.isfinite(det_k).all())
        err = max(row_err(scal_k, scal_p, 0), row_err(det_k, det_p, (1, 2)))
        if (n, d, dname) == (98304, 60, "float64"):
            main_abs_err = max(float((scal_k - scal_p).abs().max()),
                               float((det_k - det_p).abs().max()))
        print(f"K5 ({n}, {d}) {dname}, {variant} variant: max error "
              f"kernel-plain per output row, relative to the row's largest "
              f"entry, {err:.3e} (limit {lim:g})", flush=True)
        check(finite, f"K5 non-finite at ({n}, {d}) {dname}")
        check(err <= lim, f"K5 kernel vs plain {err} > {lim}")
        misaligned = any(x.data_ptr() % 16 for x in args)
        check(misaligned == (n == 1001), f"K5 at ({n}, {d}) {dname}: planes "
              f"misaligned {misaligned}")
        check(variant == ("scalar" if misaligned or d % 2 else "vector"),
              f"K5 at ({n}, {d}) {dname} ran the {variant} variant")
    del few

    n, d = 98304, 60
    timed = in_turns(wm_diag.wm_diag_derived, wm_diag.wm_diag_derived_plain,
                     None, *planes, pack)
    b = bound((14 * n * d + wm_diag.N_SCAL * n + 17 * d) * 8,
              K5_FLOPS * n * d)
    print(timing_line("K5", "(98304, 60) float64", timed, *b, "none"),
          flush=True)
    # the reduced-precision modes' type: float32, the FP32 peak
    planes32 = [x.to(torch.float32).contiguous() for x in planes]
    t32 = in_turns(wm_diag.wm_diag_derived, wm_diag.wm_diag_derived_plain,
                   None, *planes32, pack.to(torch.float32).contiguous())
    print(timing_line("K5", "(98304, 60) float32", t32,
                      *bound((14 * n * d + wm_diag.N_SCAL * n + 17 * d) * 4,
                             K5_FLOPS * n * d, True), "none"), flush=True)
    k5_direct_rows(wm_diag, {"float64": (planes, pack),
                             "float32": (planes32,
                                         pack.to(torch.float32).contiguous())})
    del planes, planes32
    torch.cuda.empty_cache()
    return dict(timed, max_abs_err=main_abs_err, bound_ms=b[0],
                bound_by=b[1])


def k5_direct_rows(wm_diag, inputs):
    """K5's C entry point called directly at (98304, 60) with the layout
    of its rule, its outputs allocated once, in turns with the wrapper
    (direct, wrapper, wrapper, direct), beside the byte bound and the share
    of it the entry point reaches; one line per type of `inputs` ({dtype
    name: (planes, pack)})."""
    import numpy as np
    import torch

    for dname, (planes, pack) in inputs.items():
        n, d = planes[0].shape
        scal = torch.empty((n, wm_diag.N_SCAL), dtype=pack.dtype,
                           device=pack.device)
        det_planes = torch.empty((4, n, d), dtype=pack.dtype,
                                 device=pack.device)
        suffix = "f64" if pack.dtype == torch.float64 else "f32"
        lay = wm_diag.layout_of(planes)
        direct = direct_call(f"semi_wm_diag_{suffix}",
                             (*planes, pack, scal, det_planes), n, d,
                             lay.vec, lay.lanes, lay.blocks)
        t = {"direct": [], "wrapper": []}
        for name in ("direct", "wrapper", "wrapper", "direct"):
            t[name] += (median_ms(direct, loops=5, calls=20)
                        if name == "direct" else
                        median_ms(wm_diag.wm_diag_derived, *planes, pack,
                                  loops=5, calls=20))
        dms, wms = (float(np.median(t[k])) for k in ("direct", "wrapper"))
        size = pack.element_size()
        b_ms, b_by = bound((14 * n * d + wm_diag.N_SCAL * n + 17 * d) * size,
                           K5_FLOPS * n * d, pack.dtype == torch.float32)
        print(f"K5 direct ({n}, {d}) {dname}: entry point called directly "
              f"{dms:.4f} ms, through the wrapper {wms:.4f} ms per call "
              f"(median of CUDA-event windows of 20 calls; layout "
              f"{tuple(lay)}); bound {b_ms:.4f} ms ({b_by}): the entry point "
              f"at {100 * b_ms / dms:.1f}% of it", flush=True)


def k6_inputs(potential, n, d, dtype, case, generator):
    """(Z, inv_m, hs) of one K6 case: the monodromy planes identity plus
    0.3 noise, the AS potential's Morse Hessian diagonals of the first d
    modes (wrapped round for d > 60) at four geometries 0.5 noise apart,
    1/m of its modes; `case` as K6_CASES says."""
    import torch

    rows = 98304 if case.startswith("view") else n
    modes = potential.omega.shape[0]
    cols = torch.arange(d, device="cuda") % modes

    def noise(*shape):
        return torch.randn(shape, generator=generator, device="cuda",
                           dtype=torch.float64)

    Z = 0.3 * noise(4, rows, d)
    Z[0::3] += 1.0
    q = noise(rows, modes)
    hs = [potential.local_expansion(q + 0.5 * noise(rows, modes))[2]
          .diag[:, cols] for _ in range(4)]
    inv_m = (1.0 / potential.masses())[cols]
    Z, inv_m = Z.to(dtype), inv_m.to(dtype).contiguous()
    hs = [h.to(dtype).contiguous() for h in hs]
    if case == "view":
        Z, hs = Z[:, 8192:8192 + n], [h[8192:8192 + n] for h in hs]
    elif case == "view odd":
        Z, hs = Z[:, 1:1 + n], [h[1:1 + n] for h in hs]
    elif case == "aliased":
        hs = [hs[1]] * 4
    elif case == "broadcast":
        hs[0] = hs[0][:1].expand(n, d)
    return Z, inv_m, tuple(hs)


def k6_phase(cli, diag_mono, model):
    """K6 against its plain version at K6_CASES, its times at (98304, 60)
    float64 and float32 in turns with the plain version, its C entry point
    called directly, and ptxas' report of its instantiations."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.ops import _build
    from semiclassical_tpu_torch.propagation import eom

    for line in kernel_ptxas(_build.build_log(), "diag_mono_kernel", "K6"):
        print(f"K6 ptxas: {line}", flush=True)
    task = {"potential": {"type": "anharmonic AS", "model_file": model}}
    potential = cli._build_potential(task, "cuda")[0]
    dt = 0.005 / units.autime_to_fs
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 7)
    main_err = None
    for n, d, dname, case, lim in K6_CASES:
        dtype = getattr(torch, dname)
        Z, inv_m, hs = k6_inputs(potential, n, d, dtype, case, g)
        w = eom._rk4_weights(dt, dtype)
        variant = diag_mono.layout_of(Z, hs).variant
        before = read_counts()["K6"]
        got = diag_mono.diag_mono_step(Z, inv_m, hs, w)
        ref = diag_mono.diag_mono_step_plain(Z, inv_m, hs, w)
        torch.cuda.synchronize()
        launches = read_counts()["K6"] - before
        err = float((got - ref).abs().max() / ref.abs().max())
        if (n, d, dname, case) == (98304, 60, "float64", "whole"):
            main_err = float((got - ref).abs().max())
        odd = n * d % 2 == 1 or case == "view odd"
        print(f"K6 ({n}, {d}) {dname} {case}, {variant} variant: max "
              f"|kernel - plain| / max |plain| {err:.3e} (limit {lim:g}), "
              f"{launches} launch", flush=True)
        check(bool(torch.isfinite(got).all()),
              f"K6 non-finite at ({n}, {d}) {dname} {case}")
        check(err <= lim, f"K6 kernel vs plain {err} > {lim} at ({n}, {d}) "
              f"{dname} {case}")
        check(launches == 1, f"K6 launched {launches} times for one call")
        check(variant == ("scalar" if odd else "vector"),
              f"K6 at ({n}, {d}) {dname} {case} ran the {variant} variant")
    out = {}
    for dname in ("float64", "float32"):
        dtype = getattr(torch, dname)
        n, d = 98304, 60
        Z, inv_m, hs = k6_inputs(potential, n, d, dtype, "whole", g)
        args = (Z, inv_m, hs, eom._rk4_weights(dt, dtype))
        timed = in_turns(diag_mono.diag_mono_step,
                         diag_mono.diag_mono_step_plain, None, *args)
        b = bound(K6_PLANES * n * d * Z.element_size(), K6_FLOPS * n * d,
                  dtype == torch.float32)
        print(timing_line("K6", f"({n}, {d}) {dname}", timed, *b, "none"),
              flush=True)
        k6_direct_row(diag_mono, dname, *args)
        if dname == "float64":
            out = dict(timed, max_abs_err=main_err, bound_ms=b[0],
                       bound_by=b[1])
        del Z, hs, args
        torch.cuda.empty_cache()
    return out


def k6_direct_row(diag_mono, dname, Z, inv_m, hs, w):
    """K6's C entry point called directly with the layout of its rule, its
    output allocated once, in turns with the wrapper (direct, wrapper,
    wrapper, direct), beside the byte bound and the share of it the entry
    point reaches."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch.ops import _build

    _, n, d = Z.shape
    out = torch.empty_like(Z)
    lay = diag_mono.layout_of(Z, hs)
    fn = getattr(_build.load(), "semi_diag_mono_"
                 + ("f64" if Z.dtype == torch.float64 else "f32"))
    args = (Z.data_ptr(), Z.stride(0), *(h.data_ptr() for h in hs), 0,
            inv_m.data_ptr(), out.data_ptr(), n * d, d, *w, lay.vec,
            lay.blocks, torch.cuda.current_stream().cuda_stream)
    check(fn(*args) == 0, "K6 entry point refused its own layout")
    t = {"direct": [], "wrapper": []}
    for name in ("direct", "wrapper", "wrapper", "direct"):
        t[name] += (median_ms(lambda: fn(*args), loops=5, calls=20)
                    if name == "direct" else
                    median_ms(diag_mono.diag_mono_step, Z, inv_m, hs, w,
                              loops=5, calls=20))
    dms, wms = (float(np.median(t[k])) for k in ("direct", "wrapper"))
    b_ms, b_by = bound(K6_PLANES * n * d * Z.element_size(),
                       K6_FLOPS * n * d, Z.dtype == torch.float32)
    print(f"K6 direct ({n}, {d}) {dname}: entry point called directly "
          f"{dms:.4f} ms, through the wrapper {wms:.4f} ms per call "
          f"(median of CUDA-event windows of 20 calls; layout "
          f"{tuple(lay)}); bound {b_ms:.4f} ms ({b_by}): the entry point "
          f"at {100 * b_ms / dms:.1f}% of it", flush=True)


def k7_inputs(potential, n, d, dtype, case, generator):
    """(q, p, S, pack) of one K7 case: q and p of the AS potential's first
    d modes (wrapped round for d > 60) at the classical scales 2 /
    sqrt(omega) and sqrt(omega), S 1e-2 noise, and the potential's pack
    over those modes; `case` as K7_CASES says."""
    import torch

    from semiclassical_tpu_torch.ops import morse_rk4

    rows = 98304 if case.startswith("view") else n
    cols = torch.arange(d, device="cuda") % potential.omega.shape[0]
    omega = potential.omega[cols]

    def noise(*shape):
        return torch.randn(shape, generator=generator, device="cuda",
                           dtype=torch.float64)

    q = (noise(rows, d) * 2.0 / omega.sqrt()).to(dtype)
    p = (noise(rows, d) * omega.sqrt()).to(dtype)
    S = (1e-2 * noise(rows)).to(dtype)
    pack = morse_rk4.pack_of(potential.to_dtype(dtype))[:, cols].contiguous()
    if case == "view":
        q, p, S = (x[8192:8192 + n] for x in (q, p, S))
    elif case == "view odd":
        q, p, S = (x[1:1 + n] for x in (q, p, S))
    return q, p, S, pack


def k7_phase(cli, morse_rk4, model):
    """K7 against its plain version at K7_CASES, its times at (98304, 60)
    float64 and float32 in turns with the plain version, its C entry point
    called directly, and ptxas' report of its instantiations."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.ops import _build
    from semiclassical_tpu_torch.propagation import eom

    for line in kernel_ptxas(_build.build_log(), "morse_rk4_kernel", "K7"):
        print(f"K7 ptxas: {line}", flush=True)
    task = {"potential": {"type": "anharmonic AS", "model_file": model}}
    potential = cli._build_potential(task, "cuda")[0]
    dt = 0.005 / units.autime_to_fs
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 8)
    main_err = None
    for n, d, dname, case, lim, lim_sums in K7_CASES:
        dtype = getattr(torch, dname)
        q, p, S, pack = k7_inputs(potential, n, d, dtype, case, g)
        w = eom._stage_weights(dt, dtype)
        variant = morse_rk4.layout_of(q, p).variant
        before = read_counts()["K7"]
        got = morse_rk4.morse_rk4_step(q, p, S, pack, w)
        ref = morse_rk4.morse_rk4_step_plain(q, p, S, pack, w)
        torch.cuda.synchronize()
        launches = read_counts()["K7"] - before
        errs = [float((x - y).abs().max() / y.abs().max())
                for x, y in zip(got, ref)]
        if (n, d, dname, case) == (98304, 60, "float64", "whole"):
            main_err = max(float((x - y).abs().max())
                           for x, y in zip(got, ref))
        odd = d % 2 == 1
        print(f"K7 ({n}, {d}) {dname} {case}, {variant} variant: max "
              f"|kernel - plain| / max |plain| q {errs[0]:.3e}, p "
              f"{errs[1]:.3e}, h {errs[4]:.3e} (limit {lim:g}; bit for "
              f"bit: {all(torch.equal(got[i], ref[i]) for i in (0, 1, 4))}"
              f"), S {errs[2]:.3e}, e1 {errs[3]:.3e} (limit {lim_sums:g}), "
              f"{launches} launch", flush=True)
        check(all(bool(torch.isfinite(x).all()) for x in got),
              f"K7 non-finite at ({n}, {d}) {dname} {case}")
        check(max(errs[0], errs[1], errs[4]) <= lim
              and max(errs[2], errs[3]) <= lim_sums,
              f"K7 kernel vs plain {errs} at ({n}, {d}) {dname} {case}")
        check(launches == 1, f"K7 launched {launches} times for one call")
        check(variant == ("scalar" if odd else "vector"),
              f"K7 at ({n}, {d}) {dname} {case} ran the {variant} variant")
    out = {}
    for dname in ("float64", "float32"):
        dtype = getattr(torch, dname)
        n, d = 98304, 60
        args = (*k7_inputs(potential, n, d, dtype, "whole", g),
                eom._stage_weights(dt, dtype))
        timed = in_turns(morse_rk4.morse_rk4_step,
                         morse_rk4.morse_rk4_step_plain, None, *args)
        b = bound((K7_PLANES * n * d + K7_ROW_NUMBERS * n)
                  * args[0].element_size(), K7_FLOPS * n * d,
                  dtype == torch.float32)
        print(timing_line("K7", f"({n}, {d}) {dname}", timed, *b, "none"),
              flush=True)
        k7_direct_row(morse_rk4, dname, *args)
        if dname == "float64":
            out = dict(timed, max_abs_err=main_err, bound_ms=b[0],
                       bound_by=b[1])
        del args
        torch.cuda.empty_cache()
    return out


def k7_direct_row(morse_rk4, dname, q, p, S, pack, w):
    """K7's C entry point called directly with the layout of its rule, its
    outputs allocated once, in turns with the wrapper (direct, wrapper,
    wrapper, direct), beside the byte bound and the share of it the entry
    point reaches."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch.ops import _build

    n, d = q.shape
    outs = [torch.empty_like(q), torch.empty_like(p), torch.empty_like(S),
            torch.empty_like(S), torch.empty((4, n, d), dtype=q.dtype,
                                             device=q.device)]
    lay = morse_rk4.layout_of(q, p)
    fn = getattr(_build.load(), "semi_morse_rk4_"
                 + ("f64" if q.dtype == torch.float64 else "f32"))
    args = (q.data_ptr(), p.data_ptr(), S.data_ptr(), pack.data_ptr(),
            *(x.data_ptr() for x in outs), n, d, *w, lay.vec, lay.blocks,
            torch.cuda.current_stream().cuda_stream)
    check(fn(*args) == 0, "K7 entry point refused its own layout")
    t = {"direct": [], "wrapper": []}
    for name in ("direct", "wrapper", "wrapper", "direct"):
        t[name] += (median_ms(lambda: fn(*args), loops=5, calls=20)
                    if name == "direct" else
                    median_ms(morse_rk4.morse_rk4_step, q, p, S, pack, w,
                              loops=5, calls=20))
    dms, wms = (float(np.median(t[k])) for k in ("direct", "wrapper"))
    b_ms, b_by = bound((K7_PLANES * n * d + K7_ROW_NUMBERS * n)
                       * q.element_size(), K7_FLOPS * n * d,
                       q.dtype == torch.float32)
    print(f"K7 direct ({n}, {d}) {dname}: entry point called directly "
          f"{dms:.4f} ms, through the wrapper {wms:.4f} ms per call "
          f"(median of CUDA-event windows of 20 calls; layout "
          f"{tuple(lay)}); bound {b_ms:.4f} ms ({b_by}): the entry point "
          f"at {100 * b_ms / dms:.1f}% of it", flush=True)


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
    potential, q0, p0, G, zpe, _, _ = cli._build_potential(task, "cuda")
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


def coumarin_run(cli, ops, smi, label, file, precision="f64"):
    """examples/coumarin_gdml/`file` at its own size through the port's CLI
    on cuda at `precision`. Returns (the rates npz as a dict, the kernels'
    launches during the dynamics command)."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        data, launches, task, wall, _ = run_path(
            cli, ops, coumarin_task(file), {}, tmp, precision)
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
    data.update(imax=imax, nsteps=nsteps, nrep=nrep, wall=wall, task=task)
    return data, launches

def check_tf32():
    """Fail if float32 matmuls would run in TF32 (the reduced-precision
    modes' monodromy products must be true FP32)."""
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would run in TF32")


def mode_line(cli, label, precision, run, cls, args, by_dtype, smi,
              prop=None, expect=None):
    """The precision phase's line: the mode, the dtypes of q, qc, Z and S
    (of `prop`, or the first batch of the run's task drawn at the mode,
    after 2 steps) and the launches by dtype; fails unless the dtypes are
    `expect` (a dict like EXPECT_DTYPES' entries) where given."""
    import torch

    from semiclassical_tpu_torch import units

    task = run["task"]
    if prop is None:
        prop, potential = first_batch(cli, task, cls, *args,
                                      precision=precision,
                                      with_potential=True)
    else:
        potential = run["potential"]
    dt = task["time_step_fs"] / units.autime_to_fs
    prop._run(potential, dt, 2)
    st = prop.state
    dtypes = {name: (None if getattr(st, name) is None
                     else str(getattr(st, name).dtype).removeprefix("torch."))
              for name in ("q", "qc", "Z", "S")}
    print(f"{label} precision {precision}: dtypes {json.dumps(dtypes)}; "
          f"launches by dtype {json.dumps(by_dtype)}; dynamics "
          f"{run['wall']:.3f} s [{smi}]", flush=True)
    check(expect is None or dtypes == expect,
          f"{label} {precision}: dtypes {dtypes}, expected {expect}")
    del prop
    torch.cuda.empty_cache()


def precision_curves(label, precision, data, ref):
    """C(t) and k~ic(t) of a reduced-precision run against the f64 run at
    the same draws, within PRECISION_GATES of the f64 curve's largest
    modulus."""
    import numpy as np

    gate_c, gate_k = PRECISION_GATES[precision]
    errs = [float(np.abs(data[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in ("autocorrelation", "ic_correlation")]
    print(f"{label} {precision} vs f64 at seed {SEED}: max |C - C_f64| / "
          f"max |C_f64| {errs[0]:.3e} (gate {gate_c:g}), k~ic {errs[1]:.3e} "
          f"(gate {gate_k:g})", flush=True)
    check(errs[0] <= gate_c and errs[1] <= gate_k,
          f"{label} {precision} vs f64: {errs}")


def reduced_launches(label, by_dtype, need):
    """No complex128 launch of K1-K4 (and no float64 one of K5-K7), and
    each kernel of `need` ({kernel: least launches}) at its reduced type at
    least that often."""
    wide = {k: v.get("complex128", v.get("float64", 0))
            for k, v in by_dtype.items()}
    check(not any(wide.values()),
          f"{label}: launches at complex128 / float64 {wide}")
    for kernel, least in need.items():
        got = by_dtype[kernel].get("complex64", by_dtype[kernel].get(
            "float32", 0))
        check(got >= least, f"{label}: {kernel} launched {got} times at its "
                            f"reduced type, expected at least {least}")


def methylium_batch_phase(cli, ops, smi, label, f64_run, precision="mixed",
                          nsteps=None, **task_keys):
    """The first batch of the methylium task of `label` ("HK" or "WM", the
    f64 phase's task with `task_keys` set) in memory, 10,000 trajectories x
    `nsteps` steps (default the task's 2000) at f64 and at `precision` from
    the same draws (cut from the example's 5 batches through the CLI, to
    keep the script's wall near 900 s; the CLI's reduced paths run in the
    AS and coumarin phases): C(t)
    and k~ic(t) against f64 within PRECISION_GATES, K1 at complex64 on
    every step (under WM also K2 three times per step and K3 twice for the
    batch's trackers: the counts are set to 0 before the batch is drawn)
    and no complex128 launch."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    task = dict(f64_run["task"], **task_keys)
    cls, args = ((WaltonManolopoulosPropagator, (CELL_WIDTH, CELL_WIDTH))
                 if label == "WM" else (HermanKlukPropagator, ()))
    dt = task["time_step_fs"] / units.autime_to_fs
    nsteps = nsteps or task["num_steps"]
    name = f"{label} methylium" + (" exact" if task.get("integrator")
                                   == "exact" else "")
    runs = {}
    for mode in ("f64", precision):
        reset_counts()
        prop, potential = first_batch(cli, task, cls, *args, precision=mode,
                                      with_potential=True)
        t0 = time.perf_counter()
        cauto, kic = prop.propagate(potential, dt, nsteps, chunk=100)
        torch.cuda.synchronize()
        runs[mode] = dict(autocorrelation=cauto, ic_correlation=kic,
                          wall=time.perf_counter() - t0, task=task,
                          potential=potential, prop=prop,
                          by_dtype=read_counts(by_dtype=True))
        print(f"{name} first batch {prop.ntraj} x {nsteps} steps at {mode}: "
              f"{runs[mode]['wall']:.3f} s, "
              f"{prop.ntraj * nsteps / runs[mode]['wall']:.0f} traj-steps/s "
              f"[{smi}]", flush=True)
        if mode == "f64":
            del prop
            runs["f64"].pop("prop")
    run = runs[precision]
    check(abs(run["autocorrelation"][0] - 1.0) < 1e-3,
          f"{name} {precision} |C(0) - 1|")
    precision_curves(f"{name} first batch", precision, run, runs["f64"])
    need = {"K1": nsteps}
    if label == "WM":
        need.update(K2=3 * nsteps, K3=2)
    reduced_launches(f"{name} {precision}", run["by_dtype"], need)
    mode_line(cli, name, precision, run, cls, args, run["by_dtype"], smi,
              prop=run.pop("prop"))


def as_comp32_phase(cli, ops, smi, model, label, file, ref,
                    **dynamics_keys):
    """The AS example `file` as shipped (with `dynamics_keys` set on its
    dynamics task) at --precision comp32, at the f64 run `ref`'s seed and
    size: the AS gates, C(t) and k~ic(t) against `ref`, K5 at float32 on
    every WM step and none at float64, the comp32 dtypes; with integrator
    "exact" also the RK4-routed rows."""
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    exact = dynamics_keys.get("integrator") == "exact"
    name = f"{label} AS exact" if exact else f"{label} AS"
    run, _ = as_run(cli, ops, smi, model,
                    f"{label} exact comp32" if exact else f"{label} comp32",
                    file, "comp32", **dynamics_keys)
    by_dtype = dict(LAST_BY_DTYPE)
    if exact:
        print(f"{name} comp32: RK4-routed rows {routed_rows(run['lines'])}",
              flush=True)
    precision_curves(name, "comp32", run, ref)
    steps = run["nsteps"] * run["nrep"]
    reduced_launches(f"{name} comp32", by_dtype,
                     {"K5": steps} if label == "WM" else {})
    cls, args = ((WaltonManolopoulosPropagator, (CELL_WIDTH, CELL_WIDTH))
                 if label == "WM" else (HermanKlukPropagator, ()))
    mode_line(cli, name, "comp32", run, cls, args, by_dtype, smi,
              expect=EXPECT_DTYPES["comp32"])


def as_f32_phase(cli, ops, smi, model, **dynamics_keys):
    """The HK AS example (with `dynamics_keys` set on its dynamics task)
    cut to 98,304 x 200 steps at f64 and at --precision f32, same seed:
    C(t) and k~ic(t) within the f32 gates, the f32 dtypes; with integrator
    "exact" also the RK4-routed rows."""
    from semiclassical_tpu_torch.propagation import HermanKlukPropagator

    name = ("HK AS exact" if dynamics_keys.get("integrator") == "exact"
            else "HK AS")
    runs = {}
    for precision in ("f64", "f32"):
        with tempfile.TemporaryDirectory() as tmp:
            data, _, task, wall, lines = run_path(
                cli, ops, as_config("semi.json", model, num_steps=200,
                                    **dynamics_keys), {}, tmp, precision)
        runs[precision] = dict(data, task=task, wall=wall, lines=lines,
                               by_dtype=dict(LAST_BY_DTYPE))
    routed = (f"; RK4-routed rows {routed_rows(runs['f32']['lines'])} at "
              "f32" if "exact" in name else "")
    print(f"{name} 98304 x 200 steps: dynamics command "
          f"{runs['f64']['wall']:.3f} s f64, {runs['f32']['wall']:.3f} s f32 "
          f"[{smi}]{routed}", flush=True)
    precision_curves(f"{name} 98304 x 200", "f32", runs["f32"], runs["f64"])
    mode_line(cli, name, "f32", runs["f32"], HermanKlukPropagator, (),
              runs["f32"]["by_dtype"], smi, expect=EXPECT_DTYPES["f32"])


def as_taylor_phase(cli, ops, smi, model, label, file, stage):
    """The AS example `file` as shipped with hessian_eval "taylor" and
    taylor_every 8 at the stage run's seed and size: the AS gates, C(t)
    against the stage run within TAYLOR_GAP_FACTOR x the JAX package's
    own taylor-vs-stage gap, the hessian_eval log line, K5 at float64 on
    every WM step."""
    import numpy as np

    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    keys = {"hessian_eval": "taylor", "taylor_every": 8}
    run, launches = as_run(cli, ops, smi, model, f"{label} taylor", file,
                           potential_keys=keys)
    by_dtype = dict(LAST_BY_DTYPE)
    logged = any(line.split() == ["hessian_eval", ":", "taylor",
                                  "(re-expansion", "every", "8", "steps)"]
                 for line in run["lines"])
    gap = float(np.abs(run["autocorrelation"]
                       - stage["autocorrelation"]).max())
    jax_gap = TAYLOR_STAGE_GAP_JAX[f"{label} AS"]
    gate = TAYLOR_GAP_FACTOR * jax_gap
    steps = run["nsteps"] * run["nrep"]
    print(f"{label} AS taylor vs stage at seed {SEED}: max_t |C_taylor - "
          f"C_stage| = {gap:.3e} (gate {gate:.3e}: {TAYLOR_GAP_FACTOR:g}x "
          f"the JAX package's {jax_gap:.3e}); per step taylor "
          f"{1e3 * run['wall'] / steps:.4f} ms, stage "
          f"{1e3 * stage['wall'] / steps:.4f} ms [{smi}]; hessian_eval line "
          f"logged: {logged}", flush=True)
    check(logged, f"{label} AS taylor: no hessian_eval log line")
    check(gap < gate, f"{label} AS taylor vs stage gap {gap:.3e} >= "
                      f"{gate:.3e}")
    if label == "WM":
        got = by_dtype["K5"].get("float64", 0)
        check(got >= steps, f"WM AS taylor: K5 launched {got} times at "
                            f"float64 for {steps} steps")
    cls, args = ((WaltonManolopoulosPropagator, (CELL_WIDTH, CELL_WIDTH))
                 if label == "WM" else (HermanKlukPropagator, ()))
    mode_line(cli, f"{label} AS taylor", "f64", run, cls, args, by_dtype,
              smi, expect=EXPECT_DTYPES["f64"])


def as_step_phase(cli, ops, smi, model):
    """The HK AS example's first batch, 98,304 x 200 steps in memory with
    hessian_eval "step" and "stage" from the same draws: q, p and S equal
    to STEP_GATE (the trajectories do not depend on the mode), C(t)'s gap
    printed (the monodromy freezes the midpoint Hessian)."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import HermanKlukPropagator

    runs = {}
    for mode in ("stage", "step"):
        task = as_config("semi.json", model, {"hessian_eval": mode},
                         num_steps=200)["semi"][0]
        reset_counts()
        prop, potential = first_batch(cli, task, HermanKlukPropagator,
                                      with_potential=True)
        dt = task["time_step_fs"] / units.autime_to_fs
        t0 = time.perf_counter()
        cauto, _ = prop.propagate(potential, dt, task["num_steps"],
                                  chunk=500)
        torch.cuda.synchronize()
        runs[mode] = dict(autocorrelation=cauto, task=task,
                          wall=time.perf_counter() - t0, prop=prop,
                          potential=potential,
                          by_dtype=read_counts(by_dtype=True))
    a, b = runs["step"]["prop"].state, runs["stage"]["prop"].state
    errs = {name: float((getattr(a, name) - getattr(b, name)).abs().max()
                        / getattr(b, name).abs().max())
            for name in ("q", "p", "S")}
    gap = float(np.abs(runs["step"]["autocorrelation"]
                       - runs["stage"]["autocorrelation"]).max())
    print(f"HK AS step: first batch {a.q.shape[0]} x 200 steps, step "
          f"{runs['step']['wall']:.3f} s, stage {runs['stage']['wall']:.3f} s"
          f" [{smi}]; step vs stage q, p, S "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" of the largest value (gate {STEP_GATE:g}); max_t |C_step - "
          f"C_stage| = {gap:.3e}", flush=True)
    check(max(errs.values()) <= STEP_GATE,
          f"HK AS step trajectories differ from stage's: {errs}")
    del runs["stage"]
    step = runs["step"]
    mode_line(cli, "HK AS step", "f64", step, HermanKlukPropagator, (),
              step["by_dtype"], smi, prop=step.pop("prop"),
              expect=EXPECT_DTYPES["f64"])


def coumarin_mixed_phase(cli, ops, smi, label, file, ref):
    """The coumarin example `file` at --precision mixed, at the f64 run's
    seed and size: its gates, C(t) and k~ic(t) against the f64 run, K4 at
    complex64 on every step (under WM also K2 three times per step and K3
    twice per batch) and no complex128 launch."""
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    run, _ = coumarin_run(cli, ops, smi, f"{label} mixed", file, "mixed")
    by_dtype = dict(LAST_BY_DTYPE)
    precision_curves(f"{label} coumarin", "mixed", run, ref)
    steps = run["nsteps"] * run["nrep"]
    need = {"K4": steps}
    if label == "WM":
        need.update(K2=3 * steps, K3=2 * run["nrep"])
    reduced_launches(f"{label} coumarin mixed", by_dtype, need)
    cls, args = ((WaltonManolopoulosPropagator, (CELL_WIDTH, CELL_WIDTH))
                 if label == "WM" else (HermanKlukPropagator, ()))
    mode_line(cli, f"{label} coumarin", "mixed", run, cls, args, by_dtype,
              smi)


def wm_norm_mixed_phase(cli, ops, smi, norm_shape):
    """The WM methylium norm's first batch of 10,000 after 100 steps at
    f64 and at mixed precision, in memory: the mixed norm (K3 at complex64
    on every block pair, none at complex128) within NORM_MIXED_GATE of the
    f64 one."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import (
        WaltonManolopoulosPropagator)

    with open(EXAMPLE) as f:
        task = json.load(f)["semi"][0]
    for key in ("ground", "excited", "coupling"):
        task["potential"][key] = str(
            (EXAMPLE.parent / task["potential"][key]).resolve())
    task.update(propagator="WM", cell_width=CELL_WIDTH, batch_size=10000,
                num_trajectories=10000)
    dt = task["time_step_fs"] / units.autime_to_fs
    nb = -(-norm_shape["n"] // norm_shape["block"])
    out = {}
    for precision in ("f64", "mixed"):
        prop, potential = first_batch(cli, task, WaltonManolopoulosPropagator,
                                      CELL_WIDTH, CELL_WIDTH,
                                      precision=precision,
                                      with_potential=True)
        prop._run(potential, dt, 100)
        reset_counts()
        t0 = time.perf_counter()
        value = prop.norm()
        torch.cuda.synchronize()
        out[precision] = (value, time.perf_counter() - t0,
                          read_counts(by_dtype=True)["K3"])
        del prop
        torch.cuda.empty_cache()
    rel = abs(out["mixed"][0] - out["f64"][0]) / abs(out["f64"][0])
    print(f"WM methylium norm mixed: 10000 trajectories after 100 steps, "
          f"norm {out['mixed'][0]:.9f} mixed ({out['mixed'][1]:.3f} s, K3 "
          f"{json.dumps(out['mixed'][2])}), {out['f64'][0]:.9f} f64 "
          f"({out['f64'][1]:.3f} s, K3 {json.dumps(out['f64'][2])}); rel "
          f"dev {rel:.3e} (gate {NORM_MIXED_GATE:g}); {nb} x {nb} block "
          f"pairs [{smi}]", flush=True)
    check(rel <= NORM_MIXED_GATE, f"WM norm mixed vs f64: {rel}")
    reduced_launches("WM methylium norm mixed",
                     {"K3": out["mixed"][2]}, {"K3": nb * nb})


# the bench phase: bench_torch's defaults on the card, the rows of the HK
# draw held at f64 beside comp32, and the pod bench's size
GRAPH_GATE = 1e-13
# the graph phase's paths: (label, example, file, propagator, precision,
# steps, keys of the dynamics task, keys of its potential); `error_bars`
# and `micro_batch` go to `propagate`
GRAPH_PATHS = [
    ("HK methylium", "methylium", "semi.json", "HK", "f64", 500, {}, {}),
    ("WM methylium", "methylium", "semi.json", "WM", "f64", 500, {}, {}),
    ("HK methylium exact", "methylium", "semi.json", "HK", "f64", 500,
     {"integrator": "exact"}, {}),
    ("WM methylium comp32", "methylium", "semi.json", "WM", "comp32", 500,
     {}, {}),
    ("HK AS error bars", "as", "semi.json", "HK", "f64", 100,
     {"error_bars": True}, {}),
    ("WM AS", "as", "semi_wm.json", "WM", "f64", 100, {}, {}),
    ("WM AS exact", "as", "semi_wm.json", "WM", "f64", 100,
     {"integrator": "exact"}, {}),
    ("HK AS comp32", "as", "semi.json", "HK", "comp32", 100, {}, {}),
    ("WM AS comp32", "as", "semi_wm.json", "WM", "comp32", 100, {}, {}),
    ("HK AS exact comp32", "as", "semi.json", "HK", "comp32", 100,
     {"integrator": "exact"}, {}),
    ("HK AS taylor", "as", "semi.json", "HK", "f64", 96, {},
     {"hessian_eval": "taylor", "taylor_every": 8}),
    ("WM AS micro_batch 8192", "as", "semi_wm.json", "WM", "f64", 40,
     {"micro_batch": 8192}, {}),
    ("HK coumarin", "coumarin", "semi.json", "HK", "f64", 96, {}, {}),
    ("WM coumarin", "coumarin", "semi_wm.json", "WM", "f64", 96, {}, {}),
]


def graph_task(example, file, model, potential_keys):
    """The dynamics task of examples/`example`/`file` with its paths made
    absolute (the AS model at `model`), `potential_keys` set on its
    potential."""
    if example == "as":
        config = as_config(file, model, potential_keys)
    elif example == "coumarin":
        config = coumarin_task(file)
    else:
        with open(EXAMPLE.parent / file) as f:
            config = json.load(f)
    task = next(t for t in config["semi"] if t["task"] == "dynamics")
    for key in ("ground", "excited", "coupling"):
        if key in task["potential"] and example == "methylium":
            task["potential"][key] = str(
                (EXAMPLE.parent / task["potential"][key]).resolve())
    task["potential"].update(potential_keys)
    return task


def graph_path(cli, ops, smi, model, label, example, file, name, precision,
               nsteps, keys, potential_keys):
    """One path of the graph phase: its first batch drawn twice at seed
    SEED, run through the graphs and under `graph.eager()`; returns the
    two runs' largest relative differences of C(t) and k~ic(t)."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator, graph)

    keys = dict(keys)
    run_keys = {k: keys.pop(k) for k in ("error_bars", "micro_batch")
                if k in keys}
    task = dict(graph_task(example, file, model, potential_keys), **keys)
    cls, args = ((WaltonManolopoulosPropagator, (CELL_WIDTH, CELL_WIDTH))
                 if name == "WM" else (HermanKlukPropagator, ()))
    dt = task["time_step_fs"] / units.autime_to_fs
    runs = {}
    for mode in ("graph", "eager"):
        prop, potential = first_batch(cli, task, cls, *args,
                                      precision=precision,
                                      with_potential=True)
        reset_counts()
        stats = dict(graph.STATS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graph.eager() if mode == "eager" else contextlib.nullcontext():
            out = prop.propagate(potential, dt, nsteps, chunk=100,
                                 **run_keys)
        torch.cuda.synchronize()
        runs[mode] = dict(
            out=out, ms=1e3 * (time.perf_counter() - t0) / nsteps,
            launches=read_counts(by_dtype=True), ntraj=prop.ntraj,
            stats={k: graph.STATS[k] - stats[k] for k in stats})
        del prop
        torch.cuda.empty_cache()
    got, ref = runs["graph"], runs["eager"]
    errs = [float(np.abs(g - r).max() / np.abs(r).max())
            for g, r in zip(got["out"][:2], ref["out"][:2])]
    st = got["stats"]
    print(f"graph {label} {got['ntraj']} x {nsteps} at {precision}: max |C "
          f"- C_eager| / max |C_eager| {errs[0]:.3e}, k~ic {errs[1]:.3e} "
          f"(gate {GRAPH_GATE:g}); graph {got['ms']:.4f} ms a step "
          f"({st['replays']} replays, {st['captures']} captures in "
          f"{st['capture_s']:.3f} s, {st['eager_blocks']} eager blocks), "
          f"eager {ref['ms']:.4f} ms a step ({ref['stats']['eager_blocks']} "
          f"blocks); launches {json.dumps(got['launches'])} [{smi}]",
          flush=True)
    check(all(e <= GRAPH_GATE for e in errs),
          f"graph {label}: graph vs eager {errs} > {GRAPH_GATE}")
    check(got["launches"] == ref["launches"],
          f"graph {label}: launches {got['launches']} under graphs, "
          f"{ref['launches']} eager")
    check(st["replays"] > 0 and ref["stats"]["replays"] == 0,
          f"graph {label}: replays {st['replays']} under graphs, "
          f"{ref['stats']['replays']} eager")
    return errs


def kept_loop_path(cli, ops, smi, model, nsteps=100):
    """HK AS exact, two batches through one time loop: the first batch's
    draw, then the same normals with the rows permuted (as many RK4-routed
    rows, at other rows and with other values), which replays the first
    batch's graphs with no capture and no eager block; each batch against
    itself under `graph.eager()` on a fresh loop: C(t) and k~ic(t) within
    GRAPH_GATE of the largest modulus, the launches by dtype equal.
    Returns the largest difference."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                     graph)
    from semiclassical_tpu_torch.sampling import (SamplingParams,
                                                  standard_normals)

    task = dict(graph_task("as", "semi.json", model, {}), integrator="exact")
    potential, q0, p0, G, _, _, _ = cli._build_potential(task, "cuda")
    dt = task["time_step_fs"] / units.autime_to_fs
    n = task["batch_size"]
    gen = torch.Generator(device="cuda").manual_seed(
        cli._repetition_seed(SEED, 0))
    x = standard_normals(SamplingParams.create(q0, p0, G, G, "cuda"), n,
                         "pseudo", gen)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))
    draws = {"first": x, "permuted": x[perm.to(x.device)]}

    def run(normals):
        prop = HermanKlukPropagator(G, G, "cuda", integrator="exact")
        prop.initial_conditions(q0, p0, G, potential, ntraj=n,
                                normals=normals)
        reset_counts()
        stats = dict(graph.STATS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prop.propagate(potential, dt, nsteps, chunk=100)
        torch.cuda.synchronize()
        return dict(out=out, ms=1e3 * (time.perf_counter() - t0) / nsteps,
                    launches=read_counts(by_dtype=True),
                    routed=int(prop._morse.pack.sub_idx.numel()),
                    stats={k: graph.STATS[k] - stats[k] for k in stats},
                    loop=graph.live("cuda"))

    graph.clear()
    kept = {name: run(normals) for name, normals in draws.items()}
    eager = {}
    for name, normals in draws.items():
        graph.clear()
        with graph.eager():
            eager[name] = run(normals)
    graph.clear()
    worst = 0.0
    for name in draws:
        got, ref = kept[name], eager[name]
        errs = [float(np.abs(g - r).max() / np.abs(r).max())
                for g, r in zip(got["out"], ref["out"])]
        worst = max(worst, *errs)
        st = got["stats"]
        print(f"graph kept loop, HK AS exact {n} x {nsteps}, {name} batch "
              f"({got['routed']} rows RK4-routed): max |C - C_eager| / max "
              f"|C_eager| {errs[0]:.3e}, k~ic {errs[1]:.3e} (gate "
              f"{GRAPH_GATE:g}); {got['ms']:.4f} ms a step ({st['replays']} "
              f"replays, {st['captures']} captures in {st['capture_s']:.3f} "
              f"s, {st['eager_blocks']} eager blocks), eager "
              f"{ref['ms']:.4f} ms a step [{smi}]", flush=True)
        check(max(errs) <= GRAPH_GATE,
              f"graph kept loop {name}: graph vs eager {errs}")
        check(got["launches"] == ref["launches"],
              f"graph kept loop {name}: launches {got['launches']} under "
              f"graphs, {ref['launches']} eager")
    first, second = kept["first"], kept["permuted"]
    check(second["loop"] is first["loop"]
          and second["stats"]["captures"] == 0
          and second["stats"]["eager_blocks"] == 0
          and second["stats"]["replays"] > 0
          and second["routed"] == first["routed"],
          f"graph kept loop: the second batch {second['stats']} "
          f"({second['routed']} routed rows, {first['routed']} in the first)"
          " did not only replay the first batch's graphs")
    return worst


def graph_phase(cli, ops, smi, model):
    """Every path of GRAPH_PATHS through the graphs and eagerly, then two
    batches through one kept loop."""
    worst = max(max(graph_path(cli, ops, smi, model, *path))
                for path in GRAPH_PATHS)
    worst = max(worst, kept_loop_path(cli, ops, smi, model))
    print(f"graph: {len(GRAPH_PATHS)} paths and a kept loop, graph vs eager "
          f"at most {worst:.3e} of the largest modulus (gate "
          f"{GRAPH_GATE:g})", flush=True)


TRACE_STAMPS = 2000
TRACE_TICK_NS = 1000
TRACE_EVENTS_GATE = 0.02
TRACE_REPLAYS = 20
# (label, example, file, steps): steps that leave a tail block, so that
# the loop holds two block lengths where the window allows
TRACE_PATHS = [("HK AS", "as", "semi.json", 105),
               ("HK coumarin", "coumarin", "semi.json", 96)]


def stamp_tick():
    """(the global timer's tick in ns, the median ns between stamps, the
    stamps that read no advance): TRACE_STAMPS stamp kernels captured in
    one CUDA graph, each into a slot of its own, replayed once, so that
    they run one after another with no host between them; the tick is the
    greatest common divisor of their advances."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch.ops import _build

    n = TRACE_STAMPS
    slots = torch.zeros(n + 1, dtype=torch.int64, device="cuda")

    def stamps():
        for i in range(-1, n):
            _build.launch("stamp", torch.int64, slots.device,
                          slots.data_ptr(), i, n)

    stamps()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stamps()
    slots.zero_()
    graph.replay()
    torch.cuda.synchronize()
    d = slots[:n].cpu().numpy()
    positive = d[d > 0]
    tick = int(np.gcd.reduce(positive)) if positive.size else 0
    return tick, float(np.median(d)), int(np.count_nonzero(d == 0))


def _device_names(prof):
    """{name: (launches, device seconds)} of a finished profile's device
    operations."""
    from torch.autograd import DeviceType

    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, sec = ops.get(e.name(), (0, 0.0))
            ops[e.name()] = (n + 1, sec + (e.end_ns() - e.start_ns()) / 1e9)
    return ops


def trace_path(cli, smi, model, label, example, file, nsteps):
    """One path of the trace phase (see the module's docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from semiclassical_tpu_torch import profiling, units
    from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                     graph)

    task = graph_task(example, file, model, {})
    potential, q0, p0, G, _, _, _ = cli._build_potential(task, "cuda")
    dt = task["time_step_fs"] / units.autime_to_fs
    error_bars = bool(task.get("error_bars", False))
    window = int(getattr(potential, "taylor_every", 1) or 1)
    lengths = set(graph.block_lengths(nsteps, window))

    def run():
        prop = HermanKlukPropagator(G, G, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cli._repetition_seed(SEED, 0))
        prop.initial_conditions(q0, p0, G, potential,
                                ntraj=task["batch_size"], generator=gen)
        return prop.propagate(potential, dt, nsteps, chunk=nsteps,
                              error_bars=error_bars)

    graph.clear()
    stats = dict(graph.STATS)
    for _ in range(2):
        run()
    warm = {k: graph.STATS[k] - stats[k] for k in stats}
    check(warm["captures"] == warm["trace_captures"] == len(lengths),
          f"trace {label}: {warm['captures']} captures and "
          f"{warm['trace_captures']} twins for {len(lengths)} block lengths")
    stats = dict(graph.STATS)
    plain = run()
    profiling.enable()
    try:
        traced = run()
    finally:
        profiling.enable(False)
    record = profiling.records()
    delta = {k: graph.STATS[k] - stats[k] for k in stats}
    check(delta["captures"] == delta["trace_captures"] == 0
          and delta["eager_blocks"] == 0,
          f"trace {label}: the runs captured or ran eagerly: {delta}")
    check(all(np.array_equal(a, b) for a, b in zip(plain, traced)),
          f"trace {label}: the traced run's curves differ from the "
          "untraced run's")
    check(record["steps"] == nsteps,
          f"trace {label}: the record holds {record['steps']} steps, "
          f"{nsteps} ran")
    ms = profiling.ms_per_step(record)
    print(f"trace {label} {task['batch_size']} x {nsteps}: curves equal "
          f"bit for bit traced and untraced; ms a step by section "
          f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}, sum "
          f"{sum(ms.values()):.4f}; host reads "
          f"{record['counters'].get('host_reads', 0)}; twins captured in "
          f"{warm['trace_capture_s']:.3f} s, graphs in "
          f"{warm['capture_s']:.3f} s [{smi}]", flush=True)

    loop = graph.live("cuda")
    length = max(lengths)
    block = loop.blocks[length]
    walls = {}
    for name, g in (("plain", block.graph), ("twin", block.twin),
                    ("twin again", block.twin), ("plain again", block.graph)):
        loop.sections.take()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(TRACE_REPLAYS):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        walls[name] = start.elapsed_time(end)
        sections_ms = 1e3 * sum(loop.sections.take().values())
        if name.startswith("twin"):
            gap = abs(sections_ms - walls[name]) / walls[name]
            print(f"trace {label}: {TRACE_REPLAYS} replays of the "
                  f"{length}-step twin: sections {sections_ms:.4f} ms, CUDA "
                  f"events {walls[name]:.4f} ms, gap {gap:.2e} (gate "
                  f"{TRACE_EVENTS_GATE:g})", flush=True)
            check(gap <= TRACE_EVENTS_GATE,
                  f"trace {label}: sections {sections_ms} ms against "
                  f"events {walls[name]} ms")
        else:
            check(sections_ms == 0.0,
                  f"trace {label}: a plain replay stamped {sections_ms} ms")
    plain_ms = min(walls["plain"], walls["plain again"])
    twin_ms = min(walls["twin"], walls["twin again"])
    print(f"trace {label}: a {length}-step block {plain_ms / TRACE_REPLAYS:.4f}"
          f" ms plain, {twin_ms / TRACE_REPLAYS:.4f} ms twin "
          f"({100 * (twin_ms / plain_ms - 1):+.2f}%)", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    ops = _device_names(prof)
    stamp = [n for n in ops if "stamp_kernel" in n]
    semi = [n for n in ops if "semi." in n]
    launches = sum(ops[n][0] for n in stamp)
    seconds = sum(ops[n][1] for n in stamp)
    busy = sum(sec for _, sec in ops.values())
    print(f"trace {label} under torch.profiler: {launches} stamp kernels, "
          f"{1e3 * seconds:.3f} ms of {1e3 * busy:.3f} device ms", flush=True)
    check(not semi and launches > 0,
          f"trace {label}: device operations {semi}, stamps {launches}")
    graph.clear()
    torch.cuda.empty_cache()


def trace_phase(cli, smi, model):
    """The global timer's tick, then each path of TRACE_PATHS."""
    tick, median, zero = stamp_tick()
    print(f"trace: the global timer's tick {tick} ns; {TRACE_STAMPS} stamps "
          f"back to back, median {median:.0f} ns apart, {zero} read no "
          f"advance [{smi}]", flush=True)
    check(0 < tick <= TRACE_TICK_NS, f"trace: global timer tick {tick} ns")
    for path in TRACE_PATHS:
        trace_path(cli, smi, model, *path)


BENCH_DEFAULTS = {"hk": (1048576, 500), "wm": (524288, 500),
                  "gdml": (32768, 100)}
BENCH_C0_GATE = 1e-3
BENCH_F64_ROWS, BENCH_F64_STEPS = 98304, 200
POD_NTRAJ, POD_NT = 131072, 100


def recording(module, name, key, shapes):
    """Wrap `module.name` (a kernel's wrapper) so that each call on CUDA
    tensors adds one to shapes[(key, shape of its first argument, dtype)]
    (a block's calls in its eager run and its capture; its replays call no
    wrapper); returns the restore function."""
    fn = getattr(module, name)

    def wrapper(*args):
        x = args[0]
        if x.device.type == "cuda":
            shapes[(key, tuple(x.shape), str(x.dtype).removeprefix(
                "torch."))] += 1
        return fn(*args)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def bench_line_checks(name, result, smi):
    """One bench's line and curves: finite values > 0, ntraj and nt as
    asked, the card's name, |C(0) - 1| below BENCH_C0_GATE."""
    import numpy as np

    line = result.line
    ntraj, nt = BENCH_DEFAULTS[name]
    cauto, kic = result.curves
    check(line["config"]["ntraj"] == ntraj and line["config"]["nt"] == nt,
          f"bench {name}: ntraj / nt {line['config']['ntraj']} / "
          f"{line['config']['nt']}, asked {ntraj} / {nt}")
    phases = line["phases"]
    values = [line["value"], line["peak_gb"],
              *(phases[k] for k in ("sample", "warmup", "scan"))]
    check(all(math.isfinite(v) and v > 0 for v in values)
          and math.isfinite(phases["reduce"]) and phases["reduce"] >= 0,
          f"bench {name}: a value is not finite and > 0: {line}")
    check(line["device"] == smi, f"bench {name}: device {line['device']}")
    check(cauto.shape == kic.shape == (nt,) and np.isfinite(cauto).all()
          and np.isfinite(kic).all(), f"bench {name}: curves not finite")
    c0 = abs(cauto[0] - 1)
    print(f"bench {name}: |C(0) - 1| = {c0:.3e} (limit {BENCH_C0_GATE:g}); "
          f"{line['value']:,.1f} traj-steps/s; scan "
          f"{line['phases']['scan']:.3f} s; peak {line['peak_gb']} GB",
          flush=True)
    check(c0 < BENCH_C0_GATE, f"bench {name}: |C(0) - 1| = {c0}")
    loop = line["graph"]
    print(f"bench {name}: the scan's time loop: {loop['replays']} replays, "
          f"{loop['captures']} captures, {loop['eager_blocks']} eager blocks "
          f"(warm-up {phases['warmup']:.3f} s)", flush=True)
    check(loop["captures"] == loop["eager_blocks"] == 0
          and loop["replays"] > 0,
          f"bench {name}: the scan captured or ran eagerly: {loop}")


def bench_gdml_eager(bench_torch, curves):
    """The gdml_coumarin bench again under `graph.eager()`: its curves
    within GRAPH_GATE of the graph run's (the bench whose scan a capture
    used to slow)."""
    import numpy as np

    from semiclassical_tpu_torch.propagation import graph

    with graph.eager():
        result = bench_torch.bench_gdml("cuda")
    graph.clear()
    errs = [float(np.abs(g - r).max() / np.abs(r).max())
            for g, r in zip(curves, result.curves)]
    print(f"bench gdml: graph run against graph.eager(): max |C - C_eager| /"
          f" max |C_eager| {errs[0]:.3e}, k~ic {errs[1]:.3e} (gate "
          f"{GRAPH_GATE:g}); eager scan {result.line['phases']['scan']:.3f} s,"
          f" {result.line['value']:,.1f} traj-steps/s", flush=True)
    check(max(errs) <= GRAPH_GATE, f"bench gdml: graph vs eager {errs}")


def bench_f64_rows(bench_torch):
    """The first BENCH_F64_ROWS rows of the HK bench's draw (the same
    generator and seed) BENCH_F64_STEPS steps at f64 and at comp32: the
    curves within comp32's gates of the f64 ones."""
    import numpy as np
    import torch

    from semiclassical_tpu_torch.sampling import (SamplingParams,
                                                  standard_normals)

    omega, _, _, _, dQ = bench_torch.as60_model()
    G = np.diag(omega)
    ntraj = BENCH_DEFAULTS["hk"][0]
    g = torch.Generator(device="cuda").manual_seed(bench_torch.SEED)
    x = standard_normals(SamplingParams.create(dQ, 0 * dQ, G, G, "cuda"),
                         ntraj, "pseudo", g)[:BENCH_F64_ROWS].clone()
    curves = {}
    for mode in ("float64", "comp32"):
        prop, pot = bench_torch.as60_setup(
            BENCH_F64_ROWS, "cuda", "HK", *bench_torch.HK_MODES[mode],
            normals=x)
        curves[mode] = prop.propagate(pot, bench_torch.AS60_DT,
                                      BENCH_F64_STEPS, check_energy=False)
        del prop
    gate_c, gate_k = PRECISION_GATES["comp32"]
    errs = [curve_gap(a, b) for a, b in zip(curves["comp32"],
                                            curves["float64"])]
    print(f"bench hk: the first {BENCH_F64_ROWS} rows of the draw, "
          f"{BENCH_F64_STEPS} steps, comp32 against f64: C(t) {errs[0]:.3e} "
          f"(limit {gate_c:g}), k~ic(t) {errs[1]:.3e} (limit {gate_k:g})",
          flush=True)
    check(errs[0] <= gate_c and errs[1] <= gate_k,
          f"bench hk: comp32 rows vs f64 {errs}")


def bench_k5_row(wm_diag, planes, pack):
    """K5 on the WM bench's own planes ((524,288, 60) float32) against its
    plain version, per output row, and timed in turns beside the bound."""
    import torch

    n, d = planes[0].shape
    scal_k, det_k = wm_diag.wm_diag_derived(*planes, pack)
    scal_p, det_p = wm_diag.wm_diag_derived_plain(*planes, pack)

    def row_err(got, ref, dims):
        scale = ref.abs().amax(dim=dims)
        return float(((got - ref).abs().amax(dim=dims)
                      / torch.where(scale > 0, scale, 1.0)).max())

    err = max(row_err(scal_k, scal_p, 0), row_err(det_k, det_p, (1, 2)))
    print(f"K5 bench ({n}, {d}) {pack.dtype}: max error kernel-plain per "
          f"output row {err:.3e} (limit 1e-5)", flush=True)
    check(err <= 1e-5, f"K5 at the WM bench's planes: {err}")
    del scal_k, det_k, scal_p, det_p
    timed = in_turns(wm_diag.wm_diag_derived, wm_diag.wm_diag_derived_plain,
                     None, *planes, pack, plain_windows=(3, 5))
    b = bound((14 * n * d + wm_diag.N_SCAL * n + 17 * d) * 4,
              K5_FLOPS * n * d, True)
    print(timing_line("K5", f"({n}, {d}) float32, the WM bench's planes",
                      timed, *b, "none"), flush=True)


def bench_k4_row(det_block, n, r=45):
    """K4 at the coumarin bench's shape (n, 45, 45) complex64 against its
    plain version and torch.linalg.det, timed in turns beside the bound."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 14)
    A = well_conditioned(n, r, torch.complex64, g)
    got = det_block.batched_det_block(A)
    plain = det_block.batched_det_lu_plain(A)
    ref = torch.linalg.det(A.to(torch.complex128))
    e_kp, e_ko = max_rel(got, plain), max_rel(got, ref)
    print(f"K4 bench ({n}, {r}, {r}) complex64: max rel err kernel-plain "
          f"{e_kp:.3e} (limit 1e-5), kernel-oracle {e_ko:.3e} (limit 1e-4)",
          flush=True)
    check(bool(torch.isfinite(got).all()) and e_kp <= 1e-5 and e_ko <= 1e-4,
          f"K4 at ({n}, {r}, {r}) complex64: {e_kp}, {e_ko}")
    timed = in_turns(det_block.batched_det_block,
                     det_block.batched_det_lu_plain, torch.linalg.det, A,
                     plain_windows=(2, 1), library_windows=(3, 5))
    b = bound(n * (r * r + 1) * 8, lu_flops(n, r), True)
    print(timing_line("K4", f"({n}, {r}, {r}) complex64, the coumarin "
                      "bench's prefactor", timed, *b, "torch.linalg.det"),
          flush=True)


def bench_phase(ops, smi):
    """bench_torch's three benches in this process at the card defaults,
    through `run_benches` (the path `python3 bench_torch.py` runs), with
    the kernels' counts set to 0 just before and read just after; then the
    f64 rows and the K4 / K5 rows at the benches' shapes."""
    import collections

    import torch

    import bench_torch
    from semiclassical_tpu_torch.propagation import wm

    shapes = collections.Counter()
    kept = {}

    def on_result(name, result):
        bench_line_checks(name, result, smi)
        if name == "wm":
            prop = result.prop
            planes, _ = wm.wm_diag_inputs(prop.params, prop.bc, prop.state,
                                          result.potential)
            kept["k5"] = (planes, prop.params.diag_pack)

    restore = [
        recording(ops["wm_diag"], "wm_diag_derived", "K5", shapes),
        recording(ops["det_block"], "batched_det_block", "K4", shapes)]
    torch.cuda.empty_cache()
    reset_counts()
    try:
        results = bench_torch.run_benches("cuda", on_result=on_result)
    finally:
        for undo in restore:
            undo()
    counts, by_dtype = read_counts(), read_counts(by_dtype=True)
    errors = [r for r in results.values()
              if not isinstance(r, bench_torch.BenchResult)]
    check(not errors, f"bench: {errors}")
    for name in bench_torch.PRINT_ORDER:
        print(json.dumps(results[name].line), flush=True)
    lines = {name: r.line for name, r in results.items()}
    nt_wm, nt_gdml = BENCH_DEFAULTS["wm"][1], BENCH_DEFAULTS["gdml"][1]
    n_wm, n_gdml = BENCH_DEFAULTS["wm"][0], BENCH_DEFAULTS["gdml"][0]
    micro = lines["gdml"]["config"]["micro_batch"] or n_gdml
    # the wrappers run in the eager blocks and the captures; a replay
    # launches what its capture recorded, so every launch of a kernel was
    # at a shape its wrapper saw
    k5_shape, k4_shape = (("K5", (n_wm, 60), "float32"),
                          ("K4", (micro, 45, 45), "complex64"))
    seen = lambda kernel: {k for k in shapes if k[0] == kernel}
    print(f"bench launches in the phase: {json.dumps(counts)}; by dtype "
          f"{json.dumps(by_dtype)}; by shape "
          f"{json.dumps({str(k): v for k, v in shapes.items()})}",
          flush=True)
    scan_launches = lambda name, k, t: (
        lines[name]["launches_by_dtype"].get(k, {}).get(t, 0))
    k5_scan = scan_launches("wm", "K5", "float32")
    check(k5_scan >= nt_wm and seen("K5") == {k5_shape}
          and by_dtype["K5"]["float64"] == 0,
          f"bench wm: K5 {k5_scan} times in the scan for {nt_wm} steps, at "
          f"the shapes {seen('K5')}, float64 {by_dtype['K5']['float64']}")
    subs = n_gdml // micro
    k4_scan = scan_launches("gdml", "K4", "complex64")
    check(k4_scan >= subs * nt_gdml and seen("K4") == {k4_shape}
          and by_dtype["K4"]["complex128"] == 0,
          f"bench gdml: K4 {k4_scan} times in the scan for {nt_gdml} steps, "
          f"at the shapes {seen('K4')}, complex128 "
          f"{by_dtype['K4']['complex128']}")
    gdml_curves = results["gdml"].curves
    del results
    torch.cuda.empty_cache()
    bench_gdml_eager(bench_torch, gdml_curves)
    bench_f64_rows(bench_torch)
    bench_k5_row(ops["wm_diag"], *kept.pop("k5"))
    torch.cuda.empty_cache()
    bench_k4_row(ops["det_block"], micro)
    torch.cuda.empty_cache()


VR_C0_GATE = 1e-3


def vr_phase(ops, smi):
    """scripts/torch_vr_flagship_bench.py at its defaults in this process
    (3 methods x 6 keys of 65,536 x 100 on the AS60 model, HK comp32): its
    lines; every batch through one time loop, so the study captures once
    per block length and runs one eager block per length; finite
    variances; |C(0) - 1| below VR_C0_GATE on every batch."""
    import importlib.util

    import numpy as np

    from semiclassical_tpu_torch.propagation import graph

    spec = importlib.util.spec_from_file_location(
        "torch_vr_flagship_bench",
        ROOT / "scripts" / "torch_vr_flagship_bench.py")
    vr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vr)
    graph.clear()
    reset_counts()
    t0 = time.perf_counter()
    out = vr.run(device="cuda")
    wall = time.perf_counter() - t0
    graph.clear()
    launches = read_counts()
    lines = [line for line, _ in out]
    for line in lines:
        print(f"vr: {json.dumps(line)}", flush=True)
    nt = lines[0]["nt"]
    lengths = block_lengths_of(nt, nt)
    total = {k: sum(line["graph"][k] for line in lines)
             for k in ("captures", "eager_blocks", "replays", "capture_s")}
    batches = sum(line["keys"] for line in lines)
    c0 = max(float(np.abs(cs[:, 0] - 1).max()) for _, (cs, _) in out)
    print(f"vr: {batches} batches in {wall:.1f} s, one time loop: "
          f"{total['captures']} captures in {total['capture_s']:.3f} s, "
          f"{total['eager_blocks']} eager blocks, {total['replays']} replays "
          f"for {len(lengths)} block length(s); max |C(0) - 1| {c0:.3e} "
          f"(limit {VR_C0_GATE:g}); launches {json.dumps(launches)} [{smi}]",
          flush=True)
    check(total["captures"] == total["eager_blocks"] == len(lengths),
          f"vr: {total} over {batches} batches, block lengths "
          f"{sorted(lengths)}")
    check(all(np.isfinite(line[k]) and line[k] > 0 for line in lines
              for k in ("var_C", "var_kic")), f"vr: variances {lines}")
    check(all(line["device"] == smi for line in lines),
          f"vr: device {lines[0]['device']}")
    check(c0 < VR_C0_GATE, f"vr: |C(0) - 1| = {c0}")


def pod_bench_phase(smi):
    """scripts/torch_pod_bench.py, HK, as a subprocess under a one-rank
    NCCL group at POD_NTRAJ x POD_NT: its line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_pod_bench.py"),
         *group_args(), "--ntraj-per-chip", str(POD_NTRAJ), "--nt",
         str(POD_NT)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(out.returncode == 0, f"pod bench exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"pod bench: {json.dumps(line)}", flush=True)
    check(line["bench"] == "pod_flagship" and line["propagator"] == "HK"
          and line["nchips"] == 1 and line["ntraj"] == POD_NTRAJ
          and line["nt"] == POD_NT, f"pod bench line {line}")
    check(all(math.isfinite(line[k]) and line[k] > 0 for k in
              ("traj_steps_per_s", "traj_steps_per_s_per_chip", "wall_s")),
          f"pod bench rates {line}")
    check(line["device"] == smi, f"pod bench device {line['device']}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from semiclassical_tpu_torch import cli
    from semiclassical_tpu_torch.ops import (_build, det, det_block,
                                             diag_mono, gj, morse_rk4,
                                             wm_diag)

    ops = {"det": det, "det_block": det_block, "gj": gj, "wm_diag": wm_diag,
           "diag_mono": diag_mono, "morse_rk4": morse_rk4}
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    check_tf32()
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
        k6 = phase("K6", k6_phase, cli, diag_mono, model)
        k7 = phase("K7", k7_phase, cli, morse_rk4, model)
        hk, hk_launches = phase("HK methylium", methylium_run, cli, ops, smi,
                                "HK")
        phase("HK methylium group", group_methylium_phase, cli, ops, smi, hk,
              hk_launches)
        wm, wm_launches = phase("WM methylium", wm_phase, cli, ops, smi, hk)
        check_tf32()
        # mixed at 500 of the example's 2000 steps: the script's wall
        phase("HK methylium mixed", methylium_batch_phase, cli, ops, smi,
              "HK", hk, nsteps=500)
        phase("WM methylium mixed", methylium_batch_phase, cli, ops, smi,
              "WM", wm, nsteps=500)
        hk_ex = phase("HK methylium exact", exact_methylium_phase, cli, ops,
                      smi, hk, hk_launches)
        phase("WM methylium exact", exact_wm_methylium_phase, cli, ops, smi,
              hk_ex, wm, wm_launches)
        phase("HK methylium exact comp32", methylium_batch_phase, cli, ops,
              smi, "HK", hk, "comp32", integrator="exact")
        phase("WM methylium exact comp32", methylium_batch_phase, cli, ops,
              smi, "WM", wm, "comp32", integrator="exact")
        hk_as, hk_as_launches = phase("HK AS", as_run, cli, ops, smi, model,
                                      "HK", "semi.json")
        steps = hk_as["nsteps"] * hk_as["nrep"]
        check(hk_as_launches["K6"] >= steps and hk_as_launches["K7"] >= steps,
              f"HK AS: K6 launched {hk_as_launches['K6']} times, K7 "
              f"{hk_as_launches['K7']} times for {steps} steps")
        phase("HK AS error bars", error_bars_identity, cli, ops, model)
        wm_as, wm_as_launches = phase("WM AS", as_run, cli, ops, smi, model,
                                      "WM", "semi_wm.json")
        phase("HK AS comp32", as_comp32_phase, cli, ops, smi, model, "HK",
              "semi.json", hk_as)
        phase("WM AS comp32", as_comp32_phase, cli, ops, smi, model, "WM",
              "semi_wm.json", wm_as)
        phase("HK AS f32", as_f32_phase, cli, ops, smi, model)
        hk_as_ex = phase("HK AS exact", exact_as_phase, cli, ops, smi, model,
                         "HK", "semi.json", hk_as, hk_as_launches)
        wm_as_ex = phase("WM AS exact", exact_as_phase, cli, ops, smi, model,
                         "WM", "semi_wm.json", wm_as, wm_as_launches)
        phase("HK AS exact comp32", as_comp32_phase, cli, ops, smi, model,
              "HK", "semi.json", hk_as_ex, integrator="exact")
        phase("WM AS exact comp32", as_comp32_phase, cli, ops, smi, model,
              "WM", "semi_wm.json", wm_as_ex, integrator="exact")
        phase("HK AS exact f32", as_f32_phase, cli, ops, smi, model,
              integrator="exact")
        phase("HK AS taylor", as_taylor_phase, cli, ops, smi, model, "HK",
              "semi.json", hk_as)
        phase("WM AS taylor", as_taylor_phase, cli, ops, smi, model, "WM",
              "semi_wm.json", wm_as)
        phase("HK AS step", as_step_phase, cli, ops, smi, model)
        phase("AS exact coarse dt", coarse_phase, cli, ops, smi, model,
              hk_as_ex)
        phase("checkpoint", checkpoint_phase, cli, ops, smi, model, hk_as_ex)
        phase("sampling", sampling_phase, cli, ops, smi, model)
        wm_as_100 = phase("micro_batch", micro_phase, cli, ops, smi, model)
        phase("WM AS group", group_as_wm_phase, cli, ops, smi, model,
              wm_as_100)
        phase("HK AS norm", hk_norm_phase, cli, ops, smi, model)
    wm_norm_launches, norm_shape = phase("WM methylium norm", wm_norm_phase,
                                         cli, ops, smi)
    phase("WM methylium norm mixed", wm_norm_mixed_phase, cli, ops, smi,
          norm_shape)
    phase("accumulation mode", accumulation_phase, cli, smi)
    wm_vs_hk("AS", wm_as, hk_as, WM_HK_GATE_AS)
    steps = wm_as["nsteps"] * wm_as["nrep"]
    check(wm_as_launches["K5"] >= steps and wm_as_launches["K6"] >= steps
          and wm_as_launches["K7"] >= steps,
          f"WM AS: K5 launched {wm_as_launches['K5']} times, K6 "
          f"{wm_as_launches['K6']} times, K7 {wm_as_launches['K7']} times "
          f"for {steps} steps")
    gap = phase("coumarin reference", reference_phase, cli)
    hk_c, hk_c_launches = phase("HK coumarin", coumarin_run, cli, ops, smi,
                                "HK", "semi.json")
    wm_c, wm_c_launches = phase("WM coumarin", coumarin_run, cli, ops, smi,
                                "WM", "semi_wm.json")
    wm_vs_hk("coumarin", wm_c, hk_c, WM_HK_GAP_FACTOR * gap)
    phase("HK coumarin mixed", coumarin_mixed_phase, cli, ops, smi, "HK",
          "semi.json", hk_c)
    phase("WM coumarin mixed", coumarin_mixed_phase, cli, ops, smi, "WM",
          "semi_wm.json", wm_c)
    steps = wm_c["nsteps"] * wm_c["nrep"]
    check(wm_c_launches["K2"] >= 3 * steps,
          f"WM coumarin: K2 launched {wm_c_launches['K2']} times for "
          f"{steps} steps")
    check(wm_c_launches["K3"] >= 2 * wm_c["nrep"],
          f"WM coumarin: K3 launched {wm_c_launches['K3']} times for "
          f"{wm_c['nrep']} batches")
    with tempfile.TemporaryDirectory() as tmp:
        model = write_as_model(tmp)
        phase("graph", graph_phase, cli, ops, smi, model)
        phase("trace", trace_phase, cli, smi, model)
    phase("bench", bench_phase, ops, smi)
    phase("vr", vr_phase, ops, smi)
    phase("pod bench", pod_bench_phase, smi)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def entry(name, source, replaces, launches, measured):
        keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")
        measured = dict(measured, launches=launches)
        return {"name": name, "route": "cuda",
                "source": f"semiclassical_tpu_torch/csrc/{source}",
                "replaces": f"semiclassical_tpu/{replaces}",
                **{k: measured[k] for k in keys}}

    print(json.dumps({"kernels": [
        entry("batched_det_lu", "det_lu.cu", "ops/det_kernel.py:257",
              hk_launches["K1"], k1),
        entry("batched_det_solve_gj", "gj_det.cu", "ops/det_kernel.py:460",
              wm_launches["K2"], k2),
        entry("batched_det_inv_gj", "gj_det.cu", "ops/det_kernel.py:532",
              wm_norm_launches["K3"], k3),
        entry("batched_det_lu_block", "det_lu_block.cu",
              "ops/det_kernel.py:113",
              hk_c_launches["K4"], k4),
        entry("wm_diag_derived", "wm_diag.cu", "ops/wm_kernel.py:273",
              wm_as_launches["K5"], k5),
        entry("diag_mono_step", "diag_mono.cu",
              "propagation/eom.py:263 (XLA-fused row_map)",
              hk_as_launches["K6"], k6),
        entry("morse_rk4_step", "morse_rk4.cu",
              "propagation/eom.py:rk4_step (XLA-fused Morse stages)",
              hk_as_launches["K7"], k7),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
