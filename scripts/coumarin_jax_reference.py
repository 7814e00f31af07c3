#!/usr/bin/env python
# coding: utf-8
"""Reference curves of the coumarin sGDML example from the JAX package, at
f64 on the CPU, for holding the PyTorch port to them on the GPU.

Builds the potential of examples/coumarin_gdml/semi.json with its
`hess_dtype` dropped (an f64 Hessian: the comparison is of algebra, not of
reduced precision), draws `--ntraj` standard normals from a fixed key
through `semiclassical_tpu.sampling._standard_normals`, feeds those draws
to the propagators, and writes

* `normals` (ntraj, 2 rank): the draws;
* `cauto_hk`, `kic_hk`, `cauto_wm`, `kic_wm`: C(t) and k~ic(t) of HK and
  of WM (cell width 1e4) over `--steps` steps with the example's
  hessian_eval "taylor", taylor_every 8, propagated in scan segments of
  `--chunk` steps (the taylor window restarts at every segment);
* `cauto_stage`, `kic_stage`: HK with hessian_eval "stage" over
  `--stage-steps` steps;
* `wm_hk_gap`: |WM - HK| / HK of the IC rate at the maximum of the HK
  rate, the gap a WM run is held to against the HK run at the same draws;
* `origin`: the minimum energy the potential's energies are measured
  from (sGDML energies carry a ~1e-8 Ha floor of f64 rounding, so a
  comparison of long curves takes this origin with the normals);

together with the run's settings, into `--out`:

    python scripts/coumarin_jax_reference.py [--out tests/data/coumarin_jax_reference.npz]
"""

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "coumarin_gdml"


def load_task():
    """The example's dynamics and rates tasks, its paths made absolute and
    its `hess_dtype` dropped."""
    with open(EXAMPLE / "semi.json") as f:
        dyn, rates = json.load(f)["semi"][:2]
    for key in ("ground", "excited", "coupling"):
        dyn["potential"][key] = str((EXAMPLE / dyn["potential"][key]).resolve())
    dyn["potential"].pop("hess_dtype", None)
    return dyn, rates


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ntraj", type=int, default=256)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--stage-steps", type=int, default=200)
    parser.add_argument("--chunk", type=int, default=500)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--cell-width", type=float, default=1e4)
    parser.add_argument("--out", default=str(
        ROOT / "tests" / "data" / "coumarin_jax_reference.npz"))
    args = parser.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    sys.path.insert(0, str(ROOT))
    from semiclassical_tpu import cli, sampling, units
    from semiclassical_tpu.analysis import rate_from_correlation
    from semiclassical_tpu.propagation import (HermanKlukPropagator,
                                               WaltonManolopoulosPropagator)
    from semiclassical_tpu.pytree import replace

    dyn, rate_task = load_task()
    pot, q0, p0, G0, zpe, gap, _ = cli._build_potential(dyn)
    dt = dyn["time_step_fs"] / units.autime_to_fs
    sp = sampling.SamplingParams.create(q0, p0, G0, G0)
    normals = np.asarray(sampling._standard_normals(
        sp, jax.random.key(args.seed), args.ntraj, "pseudo"))
    sampling._standard_normals = (
        lambda params, key, ntraj, method: jnp.asarray(normals))

    def run(prop, potential, nt, chunk):
        prop.initial_conditions(q0, p0, G0, ntraj=args.ntraj, key=0,
                                potential=potential)
        t0 = time.perf_counter()
        cauto, kic = prop.propagate(potential, dt, nt, energy0_es=zpe,
                                    chunk=chunk)
        print(f"{type(prop).__name__} {potential.hessian_eval} "
              f"{args.ntraj} x {nt}: {time.perf_counter() - t0:.1f} s, "
              f"C(0) = {complex(cauto[0]):.9f}", flush=True)
        return np.asarray(cauto), np.asarray(kic)

    f64 = dict(dtype=jnp.float64, traj_dtype=jnp.float64)
    out = {}
    out["cauto_hk"], out["kic_hk"] = run(
        HermanKlukPropagator(G0, G0, **f64), pot, args.steps, args.chunk)
    out["cauto_wm"], out["kic_wm"] = run(
        WaltonManolopoulosPropagator(G0, G0, args.cell_width,
                                     args.cell_width, **f64),
        pot, args.steps, args.chunk)
    stage = replace(pot, hessian_eval="stage", taylor_every=1)
    out["cauto_stage"], out["kic_stage"] = run(
        HermanKlukPropagator(G0, G0, **f64), stage, args.stage_steps,
        args.chunk)

    _, _, _, lineshape = cli._build_lineshape(rate_task)
    times = np.linspace(0.0, args.steps * dt, args.steps)
    rate = {}
    for name in ("hk", "wm"):
        energies, r = rate_from_correlation(times, out[f"kic_{name}"],
                                            lineshape)
        rate[name] = r[energies >= 0.0].real
    imax = int(np.argmax(rate["hk"]))
    wm_hk_gap = abs(rate["wm"][imax] - rate["hk"][imax]) / abs(
        rate["hk"][imax])
    print(f"JAX f64 CPU, coumarin, {args.ntraj} trajectories x {args.steps} "
          f"steps, taylor_every {dyn['potential']['taylor_every']}, chunk "
          f"{args.chunk}: |WM - HK| / HK at the HK rate's maximum = "
          f"{wm_hk_gap:.6e}", flush=True)

    np.savez(args.out, normals=normals, wm_hk_gap=wm_hk_gap, seed=args.seed,
             ntraj=args.ntraj, steps=args.steps, stage_steps=args.stage_steps,
             chunk=args.chunk, cell_width=args.cell_width,
             taylor_every=dyn["potential"]["taylor_every"],
             adiabatic_gap=gap, zero_point_energy=zpe,
             origin=float(pot.origin), **out)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
