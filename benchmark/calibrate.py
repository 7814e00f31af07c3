"""The readings the limits of `correct` are set from: for each seed, one
repetition of the cell through the port (set-up and warm-up as in a run)
and one through the control (the plain reference at float32 in the
port's place), each held against the float64 reference by the check of
`correct`. One process, all seeds; on the cell's own card and size (the
port through `run.execute`: a cell on several cards as a group of that
many ranks, this process rank 0; the control in this process alone). In
a cell that takes norms each row also gives every norm compared, the
port's beside the reference's.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
                                   [--control-seeds 1,2,3]
                                   [--out calibrate.json]

Prints one line per seed and side; with --out, writes them as JSON."""

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    import run as bench_run
    from semibench import cell as cells, check, control, window

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    device = torch.device("cuda", 0)
    rows = []
    sides = [("program", int(s)) for s in args.seeds.split(",") if s]
    sides += [("control", int(s)) for s in args.control_seeds.split(",")
              if s]
    for side, seed in sides:
        t0 = time.perf_counter()
        if side == "program":
            run = bench_run.execute(cell, seed, float("inf"), False, device,
                                    max_reps=1, t0=t0)
        else:
            # the control is the reference in one process, whatever the
            # cell's cards
            run = window.execute(cell, seed, float("inf"), False, device,
                                 t0, system=control.Control(cell),
                                 max_reps=1)
        t1 = time.perf_counter()
        nums = check.numbers(run)
        row = {"side": side, "seed": seed, "run_s": t1 - t0,
               "check_s": time.perf_counter() - t1,
               **{n: v for n, v, _ in nums}}
        if run.norm_readings:
            row["norms"] = [[step, float(got), float(want)]
                            for step, got, want in run.norm_readings]
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
