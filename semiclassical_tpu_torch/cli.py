# coding: utf-8
"""`semi-torch` — the port's command-line task runner.

The same user contract as `semi` (semiclassical_tpu.cli): JSON input
documents of the form {"semi": [task, ...]}, the same task keywords and the
same `.npz` accumulation semantics, for the subcommands ported so far:

    python -m semiclassical_tpu_torch.cli dynamics input.json [--device cuda]
    python -m semiclassical_tpu_torch.cli rates input.json

`dynamics` runs on the device named by `--device` (default `cuda`); it
raises when that device is not available and never moves to another one.
Task keywords and subcommands outside the ported slice raise
`ConfigurationError` naming them, rather than being ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os.path
import sys

import numpy as np

from semiclassical_tpu_torch.config import ConfigurationError, validate_task

logger = logging.getLogger(__name__)

__all__ = ["main", "run_semiclassical_dynamics", "calculate_rates",
           "check_slice", "ConfigurationError"]

# subcommands of `semi` that the port does not have yet
NOT_PORTED_COMMANDS = ("spectrum", "show", "export", "plot")
# dynamics task keywords whose features the port does not have yet
NOT_PORTED_KEYS = ("checkpoint", "checkpoint_every", "error_bars",
                   "calc_norm_every", "norm_samples", "micro_batch",
                   "export_initial", "export_final")


def main(argv=None):
    import semiclassical_tpu_torch

    parser = argparse.ArgumentParser(prog="semi-torch")
    parser.add_argument(
        "--version", action="version",
        version=f"%(prog)s {semiclassical_tpu_torch.__version__} "
                f"[Python {'.'.join(map(str, sys.version_info[:3]))}]")
    subparsers = parser.add_subparsers(help="commands", dest="command")

    parser_dynamics = subparsers.add_parser(
        "dynamics", help="run semiclassical dynamics")
    parser_dynamics.add_argument("json_input", type=str, metavar="input.json")
    parser_dynamics.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of the propagation (default cuda; 'cpu' runs "
             "the plain versions of the kernels)")
    parser_dynamics.add_argument(
        "--precision", type=str, default="f64",
        help="numerical mode; only f64 (float64/complex128 end to end) is "
             "ported")

    parser_rates = subparsers.add_parser(
        "rates",
        help="compute Fermi's-Golden-Rule rates by Fourier transforming "
             "correlation functions")
    parser_rates.add_argument("json_input", type=str, metavar="input.json")

    for name in NOT_PORTED_COMMANDS:
        sub = subparsers.add_parser(name, help="not ported yet")
        sub.add_argument("rest", nargs="*")

    args = parser.parse_args(argv)
    logging.basicConfig(format="[%(module)-12s] %(message)s",
                        level=logging.INFO)

    if args.command in NOT_PORTED_COMMANDS:
        raise ConfigurationError(
            f"subcommand '{args.command}' is not ported yet (ported: "
            "dynamics, rates)")
    if args.command == "dynamics":
        tasks = _load_tasks(args.json_input, "dynamics")
        for task in tasks:
            check_slice(task)
        for task in tasks:
            run_semiclassical_dynamics(task, device=args.device,
                                       precision=args.precision)
    elif args.command == "rates":
        if not args.json_input.endswith(".json"):
            raise ConfigurationError(
                "The argument for the command 'rates' should be the JSON "
                f"control file, got '{args.json_input}' instead.")
        for task in _load_tasks(args.json_input, "rates"):
            calculate_rates(task)
    else:
        parser.print_help()
    return 0


def _load_tasks(json_input, kind):
    """Validate every task of the document; return those of `kind`."""
    with open(json_input) as f:
        config = json.load(f)
    logger.info(f"run all '{kind}' tasks in {json_input}")
    for task in config["semi"]:
        validate_task(task)
    return [task for task in config["semi"] if task["task"] == kind]


def check_slice(task):
    """Raise ConfigurationError, naming the keyword, for a dynamics task
    that asks for anything outside the ported slice (HK, or WM with
    `cell_width`; molecular harmonic PES or the anharmonic AS model with
    the 4-stage Hessian, RK4, pseudo-random sampling)."""
    propagator = task.get("propagator", "HK")
    if propagator not in ("HK", "WM"):
        raise ConfigurationError(
            f"propagator '{propagator}' is not ported (ported: 'HK', 'WM')")
    ptype = task["potential"]["type"]
    if ptype not in ("harmonic", "anharmonic AS"):
        raise ConfigurationError(
            f"potential type '{ptype}' is not ported yet (ported: "
            "'harmonic', 'anharmonic AS')")
    hessian_eval = task["potential"].get("hessian_eval", "stage")
    if hessian_eval != "stage":
        raise ConfigurationError(
            f"hessian_eval '{hessian_eval}' is not ported yet (ported: "
            "'stage')")
    if task["potential"].get("taylor_every", 1) != 1:
        raise ConfigurationError(
            "potential keyword 'taylor_every' is not ported yet")
    integrator = task.get("integrator", "rk4")
    if integrator != "rk4":
        raise ConfigurationError(
            f"integrator '{integrator}' is not ported yet (ported: 'rk4')")
    sampling = task.get("sampling", "pseudo")
    if sampling != "pseudo":
        raise ConfigurationError(
            f"sampling '{sampling}' is not ported yet (ported: 'pseudo')")
    for key in NOT_PORTED_KEYS:
        if key in task:
            raise ConfigurationError(
                f"task keyword '{key}' is not ported yet")


def _build_potential(task, device):
    """(potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap) from the task's
    `potential` section. For the harmonic PES the energy origin is moved to
    the minimum of the final PES; the AS model has no adiabatic gap
    (NaN)."""
    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.io import FormattedCheckpointFile
    from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                    MorsePotential, minimize)

    p = task["potential"]
    if p["type"] == "anharmonic AS":
        data = np.loadtxt(p["model_file"])
        if data.ndim == 1:
            data = data.reshape(1, -1)
        logger.info("vibrational modes (cm^-1):")
        logger.info(f"{data[:, 0]}")
        omega = data[:, 0] / units.hartree_to_wavenumbers
        S, nac, chi = data[:, 1], data[:, 2], data[:, 3]
        # horizontal shift dQ from the Huang-Rhys factor S = dQ^2 omega / 2
        dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
        dQ[omega == 0.0] = 0.0
        potential = MorsePotential.create(omega, chi, nac, device=device)
        return (potential, dQ, 0.0 * dQ, np.diag(omega),
                float(np.sum(0.5 * omega)), np.nan)
    with open(p["ground"]) as f:
        freq_fchk = FormattedCheckpointFile(f)
    with open(p["coupling"]) as f:
        nacs_fchk = FormattedCheckpointFile(f)
    potential = MolecularHarmonicPotential.from_fchk(freq_fchk, nacs_fchk,
                                                     device=device)
    with open(p["excited"]) as f:
        excited_fchk = FormattedCheckpointFile(f)
    x0, Gamma_0, en_zpt = excited_fchk.vibrational_groundstate()
    q0 = np.asarray(x0)
    p0 = np.zeros_like(q0)

    logger.info("find minimum on final potential energy surface")
    potential = minimize(potential, q0)
    adiabatic_gap = float(excited_fchk.total_energy()
                          - potential.total_energy())
    logger.info(
        "  adiabatic excitation energy               : "
        f"{adiabatic_gap * units.hartree_to_ev:.4f} eV")
    return potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap


def _repetition_seed(seed, repetition):
    """Seed of the repetition's generator: independent streams per
    repetition from one root seed."""
    return int(np.random.SeedSequence([seed, repetition]).generate_state(1)[0])


def run_semiclassical_dynamics(task, device="cuda", precision="f64"):
    """Run one `dynamics` task; returns the PhaseTimer of the run."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.io.results import (accumulate_results,
                                                    init_results)
    from semiclassical_tpu_torch.profiling import PhaseTimer, RunMetrics
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    check_slice(task)
    if precision != "f64":
        raise ConfigurationError(
            f"precision '{precision}' is not ported yet (ported: 'f64')")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device 'cpu' (--device cpu) to run "
            "on the CPU explicitly")

    (potential, q0, p0, Gamma_0, en_zpt,
     adiabatic_gap) = _build_potential(task, device)
    Gamma_i = Gamma_0
    Gamma_t = Gamma_0

    dt = task["time_step_fs"] / units.autime_to_fs
    nt = task["num_steps"]
    t_max = nt * dt
    times = np.linspace(0.0, t_max, nt)
    logger.info(f"  time step                                 : "
                f"{dt * units.autime_to_fs:.5f} fs")
    logger.info(f"  number of time steps                      : {nt}")
    logger.info(f"  propagation time                          : "
                f"{t_max * units.autime_to_fs:.5f} fs")

    batch_size = task.get("batch_size", 10000)
    num_trajectories = task.get("num_trajectories", 50000)
    num_repetitions = max(num_trajectories // batch_size, 1)
    num_samples = min(batch_size, num_trajectories)
    logger.info(f"  number of repetitions                     : "
                f"{num_repetitions}")
    logger.info(f"  number of trajectories per repetition     : "
                f"{num_samples}")
    logger.info(f"  device                                    : {device}")

    filename = task["results"].get("correlations", "correlations.npz")
    overwrite = task["results"].get("overwrite", True)
    seed = task.get("manual_seed", None)
    if seed is not None and not overwrite and os.path.exists(filename):
        raise ConfigurationError(
            "Multiple runs with the same sequence of random numbers make no "
            "sense! Do not use `manual_seed` and `overwrite=False` at the "
            "same time")
    propagator_name = task.get("propagator", "HK")
    # WM: Filinov cell widths alpha = beta
    cell_width = task.get("cell_width", 10000.0)
    init_results(filename, propagator_name, times, adiabatic_gap, en_zpt,
                 overwrite=overwrite)
    if seed is None:
        seed = int(np.random.SeedSequence().entropy)
    else:
        logger.warning("The random number generator should not be seeded "
                       "manually unless for debugging!")

    # progress readout every scan_chunk steps (one host read per chunk);
    # the separable AS steps are short, so they read back less often
    default_chunk = (500 if task["potential"]["type"] == "anharmonic AS"
                     else 100)
    scan_chunk = task.get("scan_chunk", default_chunk)

    def _progress(done, total, cauto_last):
        t_fs = times[min(done, nt) - 1] * units.autime_to_fs
        logger.info(f" time/fs= {t_fs:9.4f}  step {done}/{total}  "
                    f"|C(t)|= {abs(cauto_last):.6f}")

    ptimer = PhaseTimer(device)
    traj_steps = 0
    for repetition in range(num_repetitions):
        logger.info(f"*** Repetition {repetition + 1} ***")
        generator = torch.Generator(device=device)
        generator.manual_seed(_repetition_seed(seed, repetition))
        if propagator_name == "WM":
            propagator = WaltonManolopoulosPropagator(
                Gamma_i, Gamma_t, cell_width, cell_width, device=device)
        else:
            propagator = HermanKlukPropagator(Gamma_i, Gamma_t,
                                              device=device)
        with ptimer.phase("sample"):
            propagator.initial_conditions(q0, p0, Gamma_0, potential,
                                          ntraj=num_samples,
                                          generator=generator)
        with ptimer.phase("scan"):
            cauto, kic = propagator.propagate(
                potential, dt, nt, energy0_es=en_zpt, chunk=scan_chunk,
                progress=_progress)
        # NaN watchdog (the energy guard inside propagate already raised
        # for NaN trajectories; this catches NaN prefactors/observables)
        if np.isnan(cauto).any() or np.isnan(kic).any():
            raise RuntimeError("encountered NaN's in correlations")
        RunMetrics.from_run(propagator.last_energies, cauto, kic).log()
        with ptimer.phase("reduce"):
            total = accumulate_results(filename, cauto, kic,
                                       propagator.ntraj)
        logger.info(f"  accumulated trajectories: {total}")
        traj_steps += propagator.ntraj * nt
    ptimer.log(traj_steps)
    return ptimer


def _build_lineshape(task):
    """Resolve the (broadening, hwhmG_ev, hwhmL_ev) task keywords into the
    time-domain lineshape callable. Returns (name, hwhmG, hwhmL, callable)."""
    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.analysis import (gaussian, lorentzian,
                                                  voigtian)

    hwhmG = task.get("hwhmG_ev", 0.01)
    hwhmL = task.get("hwhmL_ev", 1.0e-6)
    sigma = hwhmG / np.sqrt(2.0 * np.log(2.0)) / units.hartree_to_ev
    gamma = hwhmL / units.hartree_to_ev

    broad = task.get("broadening", "gaussian")
    if broad == "gaussian":
        lineshape = gaussian(sigma)
    elif broad == "lorentzian":
        lineshape = lorentzian(gamma)
    elif broad == "voigtian":
        lineshape = voigtian(sigma, gamma)
    else:
        raise ValueError("'broadening' should be one of 'gaussian', "
                         "'lorentzian' or 'voigtian'")
    return broad, hwhmG, hwhmL, lineshape


def calculate_rates(task):
    """Run one `rates` task on the host."""
    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.analysis import rate_from_correlation

    broad, hwhmG, hwhmL, lineshape = _build_lineshape(task)

    corr_file = task.get("correlations", "correlations.npz")
    rate_file = task.get("rates", "correlations.npz")

    logger.info(f"compute rates from correlation functions in '{corr_file}'")
    data = dict(np.load(corr_file))
    if "ic_correlation_stderr" in data:
        raise ConfigurationError(
            f"'{corr_file}' carries error bars (ic_correlation_stderr); "
            "their propagation into the rate is not ported yet")
    logger.info(f"trajectories : {data['trajectories']}")
    logger.info(
        f"time grid    : tmin= "
        f"{data['times'].min() * units.autime_to_fs:.4f} tmax= "
        f"{data['times'].max() * units.autime_to_fs:.4f} steps= "
        f"{len(data['times'])}")

    data["broadening"] = broad
    data["hwhmG"] = hwhmG
    data["hwhmL"] = hwhmL

    energies, ic_rate = rate_from_correlation(
        data["times"], data["ic_correlation"], lineshape)
    # 2 pi factor for agreement with FCclasses3
    ic_rate = ic_rate * 2.0 * np.pi

    data["energies"] = energies[energies >= 0.0]
    data["ic_rate"] = ic_rate[energies >= 0.0].real

    logger.info(f"rates are saved to '{rate_file}'")
    np.savez(rate_file, **data)


if __name__ == "__main__":
    sys.exit(main())
