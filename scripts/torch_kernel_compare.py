#!/usr/bin/env python3
# coding: utf-8
"""Time the hand-written kernels (K1 determinant, K2 det + solve, K3 det +
inverse, K4 block determinant, K5 fused separable WM step) of two
checkouts of semiclassical_tpu_torch on one NVIDIA GPU, in one process, in
turns: parent, change, change, parent.

    python3 scripts/torch_kernel_compare.py --parent DIR [--change DIR]
        [--ptxas] [--direct] [--k5-only]

`DIR` is the root of a checkout (the directory that holds
semiclassical_tpu_torch/); `--change` defaults to this script's checkout.
Each checkout builds its own kernels into its own build/kernels/. For every
shape the script prints the median per-call time of each side (CUDA
events, windows of 20 calls), the change's largest relative error against
its own plain version, and for K4 also K1 (`ops.det.batched_det`) of the
change at the same shape. The card's name and power limit head the output;
ptxas' register and spill report of both builds follows with --ptxas.

A wrapper call costs the host some 10-40 us, more than a small kernel
takes. `--direct` therefore also calls the C entry points themselves
(outputs allocated once, each side with the layout its own size rule
names):

* K2 at (n, 6, 6 | 12) for n = 10^4 and 10^5 on both sides, and on the
  change K2 at (n, 45, 45 | 45) and (| 5) and K4 at (n, 45, 45) for n = 1,
  2, 3 and 4 blocks per SM and n = 2048: the time of one block per SM is a
  block's chain of pivots, and what further blocks add shows how far they
  overlap;
* K1 and K3 on both sides at the paths' shapes, at the sizes around their
  size rules and at the large-n rows where the device time dominates a
  call ((10^6, 6, 6) for both, (10^5, 12, 12) for K3), each beside the
  wrapper's time in the same turns, the floor of a launch (the change's
  entry point at n = 1) and its bound (`chip_smoke.py`'s `bound`, bytes
  over 3.35 TB/s or flops over 34 TFLOP/s) with the share reached;
* K1 (the layout of its rule, and its warp kernel) against K4 on the
  change at r = 12 .. 32, n = 2048 and 10^4: the crossing that
  `linalg.DET_WARP_MAX_R` states;
* K5 at the 60-mode AS batch (98,304, 60) and its `micro_batch` 8192
  sub-batch, in float64 and float32: the entry point of each side (with the
  layout its own rule names) and each side's wrapper, every window's time
  kept, so that each side's median prints beside its spread (the range of
  its windows), the bound and the share of it reached.

`--k5-only` times K5 alone (K1-K4 are skipped).
"""

import argparse
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import torch

PACKAGE = "semiclassical_tpu_torch"
# K2 (n, m, k): methylium's WM leaves, coumarin's, the flagship's
K2_SHAPES = [(10000, 6, 12), (10000, 6, 6), (10000, 6, 5), (2048, 45, 90),
             (2048, 45, 45), (2048, 45, 5), (2048, 60, 120)]
# K4 and K1 (n, r): coumarin's prefactor, the largest, sizes around the rule
# of `linalg.batched_det` (K1 to r = 32), methylium's
K4_SHAPES = [(2048, 45), (2048, 64), (2048, 32), (2048, 24), (2048, 16),
             (2048, 12), (10000, 12), (10000, 6)]
# K3 (n, m): methylium's trackers, coumarin's leaf, the flagship's, the
# largest
K3_SHAPES = [(10000, 12), (10000, 6), (2048, 45), (2048, 60), (1024, 64)]


def load_side(root):
    """Every module of the package as the checkout at `root` has it, with
    its kernels built and loaded. The modules are taken out of sys.modules
    again, so that a second checkout can be imported the same way."""
    sys.path.insert(0, str(root))
    try:
        for name in ("_build", "det", "det_block", "gj", "wm_diag"):
            importlib.import_module(f"{PACKAGE}.ops.{name}")
        sys.modules[f"{PACKAGE}.ops._build"].load()
    finally:
        sys.path.remove(str(root))
        side = {name: sys.modules.pop(name) for name in list(sys.modules)
                if name.split(".")[0] == PACKAGE}
    return side


def activate(side):
    """Make `side`'s modules the package that imports resolve to (the
    wrappers import `ops._build` when they are called)."""
    for name in [n for n in sys.modules if n.split(".")[0] == PACKAGE]:
        del sys.modules[name]
    sys.modules.update(side)


def ops(side, name):
    return side[f"{PACKAGE}.ops.{name}"]


def window_ms(fn, *args, loops=10, calls=20):
    for _ in range(5):
        fn(*args)
    out = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(*args)
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / calls)
    return out


def in_turns(fns, *args):
    """Median ms per call of each (side, callable) by name, timed forth and
    back."""
    t = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        side, fn = fns[name]
        activate(side)
        t[name] += window_ms(fn, *args)
    return {name: float(np.median(v)) for name, v in t.items()}


def direct_ms(fn, *args):
    """Median ms per call of a C entry point, in windows of 50 calls."""
    return float(np.median(window_ms(fn, *args, loops=5, calls=50)))


def direct(side, entry, tensors, *ints):
    """A closure that launches the entry point `entry` of `side`'s library
    on the tensors' pointers, `ints` and the current stream."""
    fn = getattr(ops(side, "_build").load(), entry)
    args = (*(t.data_ptr() for t in tensors), *ints,
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


def direct_solve(side, A, B):
    """K2's entry point of `side` on (A, B) with outputs allocated once (a
    checkout without `solve_variant` has the entry point that takes no
    layout)."""
    gj = ops(side, "gj")
    n, m, k = B.shape
    layout = tuple(gj.solve_variant(m, k)[1:]) if hasattr(
        gj, "solve_variant") else ()
    out = (torch.empty_like(B), torch.empty(n, dtype=A.dtype, device="cuda"))
    return direct(side, "semi_gj_det_solve_c128", (A, B, *out), n, m, k,
                  *layout)


def direct_det_block(side, A):
    n, r, _ = A.shape
    out = torch.empty(n, dtype=A.dtype, device="cuda")
    return direct(side, "semi_det_lu_block_c128", (A, out), n, r)


def direct_det(side, A, kind=None):
    """K1's entry point of `side` on A with the layout its `det_variant`
    names, or `kind` (a checkout without `det_variant` has the one warp
    kernel and takes no layout)."""
    det = ops(side, "det")
    n, r, _ = A.shape
    layout = (det.LAYOUT_CODES[kind or det.det_variant(r)],) if hasattr(
        det, "det_variant") else ()
    out = torch.empty(n, dtype=A.dtype, device="cuda")
    return direct(side, "semi_det_lu_c128", (A, out), n, r, *layout)


def direct_inv(side, A):
    """K3's entry point of `side` on A (a checkout without `inv_variant`
    takes no layout)."""
    gj = ops(side, "gj")
    n, m, _ = A.shape
    layout = tuple(gj.inv_variant(m)[1:]) if hasattr(gj, "inv_variant") else ()
    out = (torch.empty_like(A), torch.empty(n, dtype=A.dtype, device="cuda"))
    return direct(side, "semi_gj_det_inv_c128", (A, *out), n, m, *layout)


def both_sides(sides, make, *args):
    """Least median ms of `make(side, *args)()` per side over the turns
    parent, change, change, parent."""
    ms = {}
    for name in ("parent", "change", "change", "parent"):
        activate(sides[name])
        ms.setdefault(name, []).append(direct_ms(make(sides[name], *args)))
    return {name: min(v) for name, v in ms.items()}


# K1 (n, r) and K3 (n, m) for --direct: the paths' shapes, the large-n rows,
# both sides of the rows kernels' limit (16 | 17) and of 8 | 9
K1_DIRECT = [(10000, 6), (1000000, 6), (10000, 2), (10000, 4), (10000, 8),
             (10000, 9), (10000, 12), (10000, 16), (10000, 17)]
K3_DIRECT = [(10000, 12), (10000, 6), (1000000, 6), (100000, 12), (2048, 45),
             (2048, 60), (1024, 64), (10000, 2), (10000, 4), (10000, 8),
             (10000, 9), (10000, 16), (10000, 17), (10000, 20), (2048, 24),
             (10000, 24), (2048, 32), (10000, 32)]
CROSSING_R = (12, 16, 20, 24, 25, 26, 27, 28, 32)


def small_kernels_phase(sides, g, smoke):
    """K1 and K3, direct and through the wrapper, on both sides, beside the
    launch floor and the bound."""
    new = sides["change"]
    for label, shapes, make, wrapper, nbytes, flops in (
            ("K1", K1_DIRECT, direct_det,
             lambda side: ops(side, "det").batched_det,
             lambda n, r: n * (r * r + 1) * 16, smoke.lu_flops),
            ("K3", K3_DIRECT, direct_inv,
             lambda side: ops(side, "gj").batched_det_inv_gj,
             lambda n, m: n * (2 * m * m + 1) * 16, smoke.gj_inv_flops)):
        for n, r in shapes:
            A, _ = inputs(n, r, 0, g)
            d = both_sides(sides, make, A)
            w = both_sides(sides, lambda side, A: (
                lambda f=wrapper(side): f(A)), A)
            activate(new)
            floor = direct_ms(make(new, A[:1].contiguous()))
            b_ms, by = smoke.bound(nbytes(n, r), flops(n, r))
            print(f"direct {label} ({n}, {r}, {r}): parent "
                  f"{1e3 * d['parent']:.1f} us, change "
                  f"{1e3 * d['change']:.1f} us "
                  f"({d['parent'] / d['change']:.2f}x); through the wrapper "
                  f"parent {1e3 * w['parent']:.1f} us, change "
                  f"{1e3 * w['change']:.1f} us; floor (change, n = 1) "
                  f"{1e3 * floor:.1f} us; bound {1e3 * b_ms:.1f} us by {by}, "
                  f"parent {100 * b_ms / d['parent']:.1f}%, change "
                  f"{100 * b_ms / d['change']:.1f}% of it", flush=True)
            del A
            torch.cuda.empty_cache()


def crossing_phase(new, g):
    """K1 against K4 on the change, direct, in turns."""
    activate(new)
    has_rows = hasattr(ops(new, "det"), "det_variant")
    for n in (2048, 10000):
        for r in CROSSING_R:
            A, _ = inputs(n, r, 0, g)
            fns = {"K1": direct_det(new, A), "K4": direct_det_block(new, A)}
            if has_rows:
                fns["K1 warp"] = direct_det(new, A, "warp")
            ms = {name: [] for name in fns}
            for name in list(fns) + list(reversed(fns)):
                ms[name].append(direct_ms(fns[name]))
            print(f"direct ({n}, {r}, {r}): " + ", ".join(
                f"{name} {1e3 * min(v):.1f} us" for name, v in ms.items()),
                flush=True)


def direct_phase(sides, g, smoke):
    for n in (10000, 100000):
        A, B = inputs(n, 6, 12, g)
        ms = both_sides(sides, direct_solve, A, B)
        print(f"direct K2 ({n}, 6, 6 | 12): parent "
              f"{1e3 * ms['parent']:.1f} us, change "
              f"{1e3 * ms['change']:.1f} us per call", flush=True)
    new = sides["change"]
    activate(new)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (sms, 2 * sms, 3 * sms, 4 * sms, 2048):
        A, B = inputs(n, 45, 45, g)
        print(f"direct, {n} matrices ({n / sms:.1f} per SM): K4 (45) "
              f"{1e3 * direct_ms(direct_det_block(new, A)):.1f} us, K2 (45 | "
              f"45) {1e3 * direct_ms(direct_solve(new, A, B)):.1f} us, K2 "
              f"(45 | 5) "
              f"{1e3 * direct_ms(direct_solve(new, A, B[:, :, :5].contiguous())):.1f}"
              f" us, K3 (45) {1e3 * direct_ms(direct_inv(new, A)):.1f} us "
              f"per call", flush=True)
    small_kernels_phase(sides, g, smoke)
    crossing_phase(new, g)
    k5_phase(sides, g, smoke)


# K5 (n, d) for --direct: the flagship batch and its micro_batch sub-batch
K5_DIRECT = [(98304, 60), (8192, 60)]


def k5_inputs(n, d, dtype, g):
    """K5's ten planes (identity-plus-noise monodromy, O(1) vectors) and the
    change's constant pack of diagonal widths in [0.001, 0.014], cell 1e4,
    at `dtype` on the card."""
    from semiclassical_tpu_torch.ops import wm_diag
    from semiclassical_tpu_torch.propagation import wm

    def noise(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float64)
    eye = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=torch.float64,
                       device="cuda")[:, None, None]
    planes = [*(eye + 0.3 * noise(4, n, d)), *noise(6, n, d)]
    omega = 0.001 + 0.013 * torch.rand(d, generator=g, device="cuda",
                                       dtype=torch.float64)
    G = torch.diag(omega).cpu().numpy()
    consts = wm.WMDiagConsts(**{
        k: torch.tensor(np.asarray(v, dtype=np.float64))
        for k, v in wm._diag_consts(G, G, G, 1e4, 1e4).items()})
    pack = wm_diag.build_const_pack(consts, noise(d).cpu(), 2.5e-3)
    return ([x.to(dtype).contiguous() for x in planes],
            pack.to(device="cuda", dtype=dtype).contiguous())


def direct_wm_diag(side, planes, pack):
    """K5's entry point of `side` on the planes, its outputs allocated
    once, with the layout `side`'s own rule names (a checkout without
    `layout_of` takes no layout)."""
    wm_diag = ops(side, "wm_diag")
    n, d = planes[0].shape
    layout = ()
    if hasattr(wm_diag, "layout_of"):
        lay = wm_diag.layout_of(planes)
        layout = (lay.vec, lay.lanes, lay.blocks)
    out = (torch.empty((n, wm_diag.N_SCAL), dtype=pack.dtype, device="cuda"),
           torch.empty((4, n, d), dtype=pack.dtype, device="cuda"))
    suffix = "f64" if pack.dtype == torch.float64 else "f32"
    return direct(side, f"semi_wm_diag_{suffix}", (*planes, pack, *out), n, d,
                  *layout)


def k5_phase(sides, g, smoke):
    """K5 direct and through the wrapper, parent and change in turns, each
    side's median beside the range of its windows, the bound and the
    share."""
    new = sides["change"]
    for dtype in (torch.float64, torch.float32):
        for n, d in K5_DIRECT:
            activate(new)
            planes, pack = k5_inputs(n, d, dtype, g)
            wm_diag = ops(new, "wm_diag")
            got = wm_diag.wm_diag_derived(*planes, pack)
            ref = wm_diag.wm_diag_derived_plain(*planes, pack)
            torch.cuda.synchronize()
            err = max(rel(got[0].T, ref[0].T), rel(got[1], ref[1]))
            t = {(kind, name): [] for kind in ("direct", "wrapper")
                 for name in ("parent", "change")}
            for name in ("parent", "change", "change", "parent"):
                side = sides[name]
                activate(side)
                t["direct", name] += window_ms(
                    direct_wm_diag(side, planes, pack), loops=5, calls=20)
                t["wrapper", name] += window_ms(
                    ops(side, "wm_diag").wm_diag_derived, *planes, pack,
                    loops=5, calls=20)
            b_ms, by = smoke.bound(
                (14 * n * d + wm_diag.N_SCAL * n + 17 * d)
                * planes[0].element_size(), smoke.K5_FLOPS * n * d,
                dtype == torch.float32)
            med = {k: float(np.median(v)) for k, v in t.items()}
            span = lambda k: f"{min(t[k]):.4f}-{max(t[k]):.4f}"
            layout = tuple(wm_diag.layout_of(planes))
            print(f"direct K5 ({n}, {d}) {str(dtype)[6:]}: parent "
                  f"{med['direct', 'parent']:.4f} ms [{span(('direct', 'parent'))}], "
                  f"change {med['direct', 'change']:.4f} ms "
                  f"[{span(('direct', 'change'))}] "
                  f"({med['direct', 'parent'] / med['direct', 'change']:.2f}x); "
                  f"through the wrapper parent "
                  f"{med['wrapper', 'parent']:.4f} ms, change "
                  f"{med['wrapper', 'change']:.4f} ms (medians [ranges] of "
                  f"{len(t['direct', 'change'])} CUDA-event windows of 20 "
                  f"calls); bound {b_ms:.4f} ms by {by}, parent "
                  f"{100 * b_ms / med['direct', 'parent']:.1f}%, change "
                  f"{100 * b_ms / med['direct', 'change']:.1f}% of it; "
                  f"change's layout {layout}, vs its plain version "
                  f"{err:.3e}", flush=True)
            del planes, got, ref
            torch.cuda.empty_cache()


def inputs(n, r, k, g):
    def noise(*shape):
        return torch.complex(
            torch.randn(shape, generator=g, device="cuda", dtype=torch.float64),
            torch.randn(shape, generator=g, device="cuda", dtype=torch.float64))
    A = (torch.eye(r, dtype=torch.complex128, device="cuda")
         + 0.3 * noise(n, r, r) / r**0.5).contiguous()
    return A, (noise(n, r, k) if k else None)


def rel(x, ref):
    """Largest error over the batch, each entry relative to its own
    matrix's largest."""
    dims = tuple(range(1, x.dim()))
    err, scale = (x - ref).abs(), ref.abs()
    if dims:
        err, scale = err.amax(dim=dims), scale.amax(dim=dims)
    return float((err / scale).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--change", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1])
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas' register / spill lines of both builds")
    ap.add_argument("--direct", action="store_true",
                    help="also time the C entry points themselves")
    ap.add_argument("--k5-only", action="store_true",
                    help="time K5 alone, direct and through the wrapper")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_compare needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    sides = {"parent": load_side(args.parent.resolve()),
             "change": load_side(args.change.resolve())}
    if args.ptxas:
        for name, side in sides.items():
            for line in ops(side, "_build").build_log().splitlines():
                if "Used" in line or "Compiling entry" in line or "spill" in line:
                    print(f"{name} build: {line.strip()}", flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    sys.path.insert(0, str(args.change.resolve()))
    import chip_smoke
    if args.k5_only:
        k5_phase(sides, g, chip_smoke)
        return 0
    new = sides["change"]
    for n, m, k in K2_SHAPES:
        A, B = inputs(n, m, k, g)
        activate(new)
        det, sol = ops(new, "gj").batched_det_solve_gj(A, B)
        det_p, sol_p = ops(new, "gj").batched_det_solve_gj_plain(A, B)
        torch.cuda.synchronize()
        err = max(rel(det, det_p), rel(sol, sol_p))
        ms = in_turns({name: (side, ops(side, "gj").batched_det_solve_gj)
                       for name, side in sides.items()}, A, B)
        print(f"K2 ({n}, {m}, {m} | {k}) complex128: parent "
              f"{ms['parent']:.4f} ms, change {ms['change']:.4f} ms "
              f"({ms['parent'] / ms['change']:.2f}x); change vs its plain "
              f"version {err:.3e}", flush=True)
    for n, r in K4_SHAPES:
        A, _ = inputs(n, r, 0, g)
        activate(new)
        err = rel(ops(new, "det_block").batched_det_block(A),
                  ops(new, "det_block").batched_det_lu_plain(A))
        fns = {name: (side, ops(side, "det_block").batched_det_block)
               for name, side in sides.items()}
        fns["K1"] = (new, ops(new, "det").batched_det)
        ms = in_turns(fns, A)
        print(f"K4 ({n}, {r}, {r}) complex128: parent {ms['parent']:.4f} ms, "
              f"change {ms['change']:.4f} ms "
              f"({ms['parent'] / ms['change']:.2f}x), K1 of the change "
              f"{ms['K1']:.4f} ms; change vs its plain version {err:.3e}",
              flush=True)
    for n, m in K3_SHAPES:
        A, _ = inputs(n, m, 0, g)
        activate(new)
        det, inv = ops(new, "gj").batched_det_inv_gj(A)
        det_p, inv_p = ops(new, "gj").batched_det_inv_gj_plain(A)
        torch.cuda.synchronize()
        err = max(rel(det, det_p), rel(inv, inv_p))
        ms = in_turns({name: (side, ops(side, "gj").batched_det_inv_gj)
                       for name, side in sides.items()}, A)
        print(f"K3 ({n}, {m}, {m}) complex128: parent {ms['parent']:.4f} ms, "
              f"change {ms['change']:.4f} ms "
              f"({ms['parent'] / ms['change']:.2f}x); change vs its plain "
              f"version {err:.3e}", flush=True)
    if args.direct:
        direct_phase(sides, g, chip_smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
