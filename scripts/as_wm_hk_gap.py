#!/usr/bin/env python
# coding: utf-8
"""WM - HK gap of the IC rate on the 60-mode anharmonic AS example, in the
JAX package at f64 on the CPU, at the same draws.

Builds examples/as_model's 60-mode model (make_model.py: rng seed 42,
chi 0.02), runs `semi dynamics` + `semi rates` of examples/as_model/
semi.json with HK and of semi_wm.json with WM (cell width 1e4) at one
`manual_seed`, shrunk to a few hundred trajectories (error bars and the
spectrum task dropped), and prints the relative difference of the two
rates at the maximum of the HK rate. chip_smoke.py's WM-vs-HK gate on
the card is set from this number.

    python scripts/as_wm_hk_gap.py [--ntraj 256] [--steps 2000 200] [--seed 1234]
"""

import argparse
import json
import os
import pathlib
import runpy
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "as_model"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ntraj", type=int, default=256)
    parser.add_argument("--steps", type=int, nargs="+", default=[2000, 200])
    parser.add_argument("--seed", type=int, default=1234)
    args = parser.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(ROOT))
    from semiclassical_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        model = tmp / "AS_model.dat"
        with open(model, "w") as f:
            stdout, sys.stdout = sys.stdout, f
            try:
                runpy.run_path(str(EXAMPLE / "make_model.py"),
                               run_name="make_model").get("main")(["", "60"])
            finally:
                sys.stdout = stdout
        for nt in args.steps:
            rates = {}
            for name, file in (("HK", "semi.json"), ("WM", "semi_wm.json")):
                with open(EXAMPLE / file) as f:
                    dyn, rate_task = json.load(f)["semi"][:2]
                npz = str(tmp / f"{name}_{nt}.npz")
                dyn.pop("error_bars", None)
                dyn["potential"]["model_file"] = str(model)
                dyn.update(num_trajectories=args.ntraj,
                           batch_size=args.ntraj, num_steps=nt,
                           manual_seed=args.seed)
                dyn["results"] = {"correlations": npz}
                cli.run_semiclassical_dynamics(dyn, num_devices=1,
                                               precision="f64")
                cli.calculate_rates(dict(rate_task, correlations=npz,
                                         rates=npz))
                rates[name] = np.load(npz)["ic_rate"]
            imax = int(np.argmax(rates["HK"]))
            rel = abs(rates["WM"][imax] - rates["HK"][imax]) / abs(
                rates["HK"][imax])
            print(f"JAX f64 CPU, 60-mode AS, {args.ntraj} trajectories x "
                  f"{nt} steps, seed {args.seed}: rate at the HK maximum "
                  f"HK {rates['HK'][imax]:.9e} WM {rates['WM'][imax]:.9e}, "
                  f"|WM - HK| / HK = {rel:.6e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
