"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, as BENCHMARK.json lists them), `device`,
with --trace 1 `breakdown`, and last `check`: each number compared with
the plain reference beside its limit (also the last lines of standard
error). Needs the cell's CUDA cards; without them it exits with 2 and
prints no result. It measures `semiclassical_tpu_torch` only: with JAX or
the JAX package loaded it exits with 3."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache of the run at a fixed path in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]

# the modules a run of the port may not hold, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "semiclassical_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def read_metrics(run, listed):
    """{name: {"value", "unit"}} of the metrics `listed` (BENCHMARK.json
    entries) that their readers find."""
    out = {}
    for m in listed:
        value = importlib.import_module(f"metrics.{m['name']}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell, seed, seconds, trace, device, system=None):
    """Set-up, window and check of one run on `device`: the result's dict,
    or an exit code where there is none to print. `system` replaces the
    port (the tests' faults)."""
    import torch

    from semibench import check, trace as tracing, window

    run = window.execute(cell, seed, seconds, trace, device, T0,
                         system=system)
    metrics = read_metrics(run, cell.metrics["per_layer" if trace
                                             else "end_to_end"])
    nums = check.numbers(run)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              "the port alone", file=sys.stderr)
        return 3
    limit = power_limit()
    on_card = device.type == "cuda"
    result = {
        "correct": check.correct(nums),
        "attempted": len(run.reps),
        "failed": len(run.reps) - len(run.done),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else device.type),
                   "count": cell.chips,
                   "memory_peak_bytes": run.peak_bytes},
        "power_limit": limit,
    }
    if trace:
        if run.trace is None:
            print("the traced window holds no trace", file=sys.stderr)
            return 4
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": tracing.top(run.trace.op_s),
                               "idle_gaps": tracing.top(run.trace.idle_s)}
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in nums}
    for rec in run.reps:
        if rec["failed"]:
            print(f"repetition {rec['index']} failed: {rec['error']}",
                  file=sys.stderr)
        else:
            tag = " (traced)" if rec["traced"] else ""
            print(f"repetition {rec['index']}{tag}: " + ", ".join(
                f"{k} {rec[k]:.4f}" for k in ("sample_s", "scan_s",
                                                "reduce_s")),
                  file=sys.stderr)
    print(f"setup_s {run.setup_s:.4f}, window_s {run.window_s:.4f}, "
          f"counters {run.counters}", file=sys.stderr)
    print(f"card: {'; '.join(limit)}", file=sys.stderr)
    for n, v, lim in nums:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from semibench import cell as cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    if isinstance(result, int):
        return result
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
