# coding: utf-8
"""`semi-torch` — the port's command-line task runner.

The same user contract as `semi` (semiclassical_tpu.cli): JSON input
documents of the form {"semi": [task, ...]}, the same task keywords and the
same `.npz` accumulation semantics, for the subcommands ported so far:

    python -m semiclassical_tpu_torch.cli dynamics input.json [--device cuda]
    python -m semiclassical_tpu_torch.cli rates input.json
    python -m semiclassical_tpu_torch.cli spectrum input.json

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
from semiclassical_tpu_torch.sampling import SAMPLING_METHODS

logger = logging.getLogger(__name__)

__all__ = ["main", "run_semiclassical_dynamics", "calculate_rates",
           "calculate_spectrum", "check_slice", "ConfigurationError"]

# subcommands of `semi` that the port does not have yet
NOT_PORTED_COMMANDS = ("show", "export", "plot")
# potential types of the ported slice
PORTED_POTENTIALS = ("harmonic", "anharmonic AS", "gdml")
_SLICE = ("the port runs HK and WM on the 'harmonic', 'anharmonic AS' and "
          "'gdml' potentials")
# dynamics task keywords whose features the port does not have yet
NOT_PORTED_KEYS = ("checkpoint", "checkpoint_every", "export_initial",
                   "export_final")


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

    parser_spectrum = subparsers.add_parser(
        "spectrum",
        help="compute the Franck-Condon spectrum by Fourier transforming the "
             "autocorrelation function")
    parser_spectrum.add_argument("json_input", type=str, metavar="input.json")

    for name in NOT_PORTED_COMMANDS:
        sub = subparsers.add_parser(name, help="not ported yet")
        sub.add_argument("rest", nargs="*")

    args = parser.parse_args(argv)
    logging.basicConfig(format="[%(module)-12s] %(message)s",
                        level=logging.INFO)

    if args.command in NOT_PORTED_COMMANDS:
        raise ConfigurationError(
            f"subcommand '{args.command}' is not ported yet (ported: "
            f"dynamics, rates, spectrum; {_SLICE})")
    if args.command == "dynamics":
        tasks = _load_tasks(args.json_input, "dynamics")
        for task in tasks:
            check_slice(task)
        for task in tasks:
            run_semiclassical_dynamics(task, device=args.device,
                                       precision=args.precision)
    elif args.command in ("rates", "spectrum"):
        if not args.json_input.endswith(".json"):
            raise ConfigurationError(
                f"The argument for the command '{args.command}' should be the "
                f"JSON control file, got '{args.json_input}' instead.")
        run = calculate_rates if args.command == "rates" else \
            calculate_spectrum
        for task in _load_tasks(args.json_input, args.command):
            run(task)
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
    `cell_width`; the molecular harmonic PES and the anharmonic AS model
    with the 4-stage Hessian, the sGDML PES with `hess_dtype`,
    `hessian_eval`, `taylor_every` and `eg_mode`; RK4), and validate the
    statistics keywords up front: `sampling`, `micro_batch`,
    `calc_norm_every` and `norm_samples`."""
    propagator = task.get("propagator", "HK")
    if propagator not in ("HK", "WM"):
        raise ConfigurationError(
            f"propagator '{propagator}' is not ported (ported: 'HK', 'WM')")
    pot = task["potential"]
    ptype = pot["type"]
    if ptype not in PORTED_POTENTIALS:
        raise ConfigurationError(
            f"potential type '{ptype}' is not ported yet (ported: "
            + ", ".join(f"'{t}'" for t in PORTED_POTENTIALS) + ")")
    hessian_eval = pot.get("hessian_eval", "stage")
    if ptype == "gdml":
        hess_dtype = pot.get("hess_dtype") or "float64"
        if hess_dtype not in ("float32", "float64"):
            raise ConfigurationError(
                f"hess_dtype '{hess_dtype}' is not ported (ported: "
                "'float32', 'float64')")
    else:
        if hessian_eval != "stage":
            raise ConfigurationError(
                f"hessian_eval '{hessian_eval}' is not ported yet for the "
                f"'{ptype}' potential (ported: 'stage'; the 'gdml' "
                "potential takes 'stage', 'step' and 'taylor')")
        if pot.get("taylor_every", 1) != 1:
            raise ConfigurationError(
                f"potential keyword 'taylor_every' is not ported yet for "
                f"the '{ptype}' potential (the 'gdml' potential takes it)")
    integrator = task.get("integrator", "rk4")
    if integrator != "rk4":
        raise ConfigurationError(
            f"integrator '{integrator}' is not ported yet (ported: 'rk4')")
    for key in NOT_PORTED_KEYS:
        if key in task:
            raise ConfigurationError(
                f"task keyword '{key}' is not ported yet ({_SLICE}, with "
                "RK4)")
    for key in ("micro_batch", "calc_norm_every", "norm_samples"):
        value = task.get(key, 0)
        if isinstance(value, bool) or not isinstance(value, int) or value < 0:
            raise ConfigurationError(
                f"task keyword '{key}' should be a non-negative int, got "
                f"{value!r}")
    sampling = task.get("sampling", "pseudo")
    if sampling not in SAMPLING_METHODS:
        raise ConfigurationError(
            f"sampling '{sampling}' is unknown (expected one of "
            + ", ".join(f"'{m}'" for m in SAMPLING_METHODS) + ")")
    if sampling == "antithetic":
        n = min(task.get("batch_size", 10000),
                task.get("num_trajectories", 50000))
        m = task.get("micro_batch", 0)
        if n % 2:
            raise ConfigurationError(
                f"sampling 'antithetic' needs an even number of trajectories "
                f"per repetition, got {n}")
        if (task.get("error_bars", False) and 0 < m < n and n % m == 0
                and m % 2):
            raise ConfigurationError(
                f"task keyword 'micro_batch' = {m} is odd: antithetic error "
                "bars need an even micro-batch size (interleaved +-pairs "
                "must not straddle a sub-batch boundary)")


def _build_potential(task, device):
    """(potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap) from the task's
    `potential` section. For the molecular PES (harmonic, gdml) the energy
    origin is moved to the minimum of the final PES and the wavepacket is
    the vibrational ground state of the excited-state fchk; the AS model
    has no adiabatic gap (NaN)."""
    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.io import FormattedCheckpointFile
    from semiclassical_tpu_torch.potentials import (MolecularGDMLPotential,
                                                    MolecularHarmonicPotential,
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
    with open(p["coupling"]) as f:
        nacs_fchk = FormattedCheckpointFile(f)
    if p["type"] == "gdml":
        model_pot = np.load(p["ground"], allow_pickle=True)
        potential = MolecularGDMLPotential.create(
            model_pot, nacs_fchk, device,
            hess_dtype=p.get("hess_dtype") or None,
            hessian_eval=p.get("hessian_eval", "stage"),
            taylor_every=p.get("taylor_every", 1),
            eg_mode=p.get("eg_mode", "f64"))
        logger.info("  hessian_eval                              : "
                    f"{potential.hessian_eval}"
                    + (f" (re-expansion every {potential.taylor_every} steps)"
                       if potential.taylor_every > 1 else ""))
    else:
        with open(p["ground"]) as f:
            freq_fchk = FormattedCheckpointFile(f)
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
    logger.info(f"  total number of trajectories              : "
                f"{num_samples * num_repetitions}")
    propagator_name = task.get("propagator", "HK")
    logger.info(f"  propagator                                : "
                f"{propagator_name}")
    # `check_slice` has refused every integrator but the default
    logger.info(f"  integrator                                : "
                f"{task.get('integrator', 'rk4')}")
    logger.info(f"  device                                    : {device}")
    calc_norm_every = task.get("calc_norm_every", 0)
    norm_samples = task.get("norm_samples", 0)
    # per-step Monte-Carlo standard errors (npz keys autocorrelation_stderr
    # / ic_correlation_stderr)
    error_bars = bool(task.get("error_bars", False))
    # variance-reduced draws of the initial conditions (sampling.
    # standard_normals); converged values are unchanged
    sampling_method = task.get("sampling", "pseudo")
    if sampling_method != "pseudo":
        logger.info(f"  sampling                                  : "
                    f"{sampling_method}")
    if error_bars and sampling_method == "sobol":
        logger.warning(
            "error_bars with sampling 'sobol': the stderr is the i.i.d. "
            "formula's (as the JAX package reports it), about 6x "
            "conservative for scrambled Sobol' points")
    # sub-batches of the time loop; no default: the whole batch runs at once
    micro = task.get("micro_batch", 0)
    if micro:
        logger.info(f"  device-side micro-batch                   : {micro}")

    filename = task["results"].get("correlations", "correlations.npz")
    overwrite = task["results"].get("overwrite", True)
    seed = task.get("manual_seed", None)
    if seed is not None and not overwrite and os.path.exists(filename):
        raise ConfigurationError(
            "Multiple runs with the same sequence of random numbers make no "
            "sense! Do not use `manual_seed` and `overwrite=False` at the "
            "same time")
    # WM: Filinov cell widths alpha = beta
    cell_width = task.get("cell_width", 10000.0)
    init_results(filename, propagator_name, times, adiabatic_gap, en_zpt,
                 overwrite=overwrite)
    if seed is None:
        seed = int(np.random.SeedSequence().entropy)
    else:
        logger.warning("The random number generator should not be seeded "
                       "manually unless for debugging!")

    # scan segments of scan_chunk steps (one host read each, and the
    # restart of a taylor_every window): the separable AS steps are short,
    # so they read back less often, and taylor-mode gdml takes the JAX
    # CLI's 500, which its window phase depends on
    default_chunk = (500 if (task["potential"]["type"] == "anharmonic AS"
                             or getattr(potential, "hessian_eval", "stage")
                             == "taylor")
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
        propagator.micro_batch = micro
        with ptimer.phase("sample"):
            propagator.initial_conditions(q0, p0, Gamma_0, potential,
                                          ntraj=num_samples,
                                          generator=generator,
                                          sampling_method=sampling_method)

        def _norm_log(step):
            t_fs = times[step] * units.autime_to_fs
            if norm_samples > 0:
                nrm, err = propagator.norm(sample_pairs=norm_samples,
                                           key=repetition)
                logger.info(f" time/fs= {t_fs:.4f}  "
                            f"norm= {nrm:9.6f} +- {err:.6f}")
            else:
                logger.info(f" time/fs= {t_fs:.4f}  "
                            f"norm= {propagator.norm():9.6f}")

        err_c = err_k = None
        if calc_norm_every > 0:
            # segments of calc_norm_every steps with the norm before each
            cauto = np.zeros(nt, dtype=complex)
            kic = np.zeros(nt, dtype=complex)
            if error_bars:
                err_c, err_k = np.zeros(nt), np.zeros(nt)
            done = 0
            while done < nt:
                seg = min(calc_norm_every, nt - done)
                _norm_log(done)
                with ptimer.phase("scan"):
                    out = propagator.propagate(potential, dt, seg,
                                               energy0_es=en_zpt,
                                               error_bars=error_bars)
                cauto[done:done + seg], kic[done:done + seg] = out[:2]
                if error_bars:
                    err_c[done:done + seg], err_k[done:done + seg] = out[2:]
                done += seg
        else:
            with ptimer.phase("scan"):
                out = propagator.propagate(
                    potential, dt, nt, energy0_es=en_zpt, chunk=scan_chunk,
                    progress=_progress, error_bars=error_bars)
            cauto, kic = out[:2]
            if error_bars:
                err_c, err_k = out[2:]
        # NaN watchdog (the energy guard inside propagate already raised
        # for NaN trajectories; this catches NaN prefactors/observables)
        if np.isnan(cauto).any() or np.isnan(kic).any():
            raise RuntimeError("encountered NaN's in correlations")
        RunMetrics.from_run(propagator.last_energies, cauto, kic).log()
        with ptimer.phase("reduce"):
            total = accumulate_results(filename, cauto, kic,
                                       propagator.ntraj,
                                       autocorrelation_stderr=err_c,
                                       ic_correlation_stderr=err_k)
        logger.info(f"  accumulated trajectories: {total}")
        if err_c is not None:
            logger.info(f"  MC stderr: |C(t)| max {err_c.max():.2e}, "
                        f"k~ic max {err_k.max():.2e}")
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
    from semiclassical_tpu_torch.analysis import (fourier_stderr,
                                                  rate_from_correlation)

    broad, hwhmG, hwhmL, lineshape = _build_lineshape(task)

    corr_file = task.get("correlations", "correlations.npz")
    rate_file = task.get("rates", "correlations.npz")

    logger.info(f"compute rates from correlation functions in '{corr_file}'")
    data = dict(np.load(corr_file))
    _log_time_grid(data)

    data["broadening"] = broad
    data["hwhmG"] = hwhmG
    data["hwhmL"] = hwhmL

    energies, ic_rate = rate_from_correlation(
        data["times"], data["ic_correlation"], lineshape)
    # 2 pi factor for agreement with FCclasses3
    ic_rate = ic_rate * 2.0 * np.pi

    data["energies"] = energies[energies >= 0.0]
    data["ic_rate"] = ic_rate[energies >= 0.0].real

    if "ic_correlation_stderr" in data:
        # the transform is linear: the per-step MC stderr of k~ic(t)
        # propagates to one scalar band for the whole rate curve, through
        # the same 2 pi and s^-1 conversions as the rate itself
        sigma = fourier_stderr(data["times"], data["ic_correlation_stderr"],
                               lineshape)
        sigma *= 2.0 * np.pi * 1.0e15 / units.autime_to_fs
        data["ic_rate_stderr"] = sigma
        logger.info(f"rate MC stderr (per energy point): {sigma:.3e} s^-1")

    logger.info(f"rates are saved to '{rate_file}'")
    np.savez(rate_file, **data)


def _log_time_grid(data):
    from semiclassical_tpu_torch import units

    logger.info(f"trajectories : {data['trajectories']}")
    logger.info(
        f"time grid    : tmin= "
        f"{data['times'].min() * units.autime_to_fs:.4f} tmax= "
        f"{data['times'].max() * units.autime_to_fs:.4f} steps= "
        f"{len(data['times'])}")


def calculate_spectrum(task):
    """Run one `spectrum` task on the host: the Fourier transform of the
    stored autocorrelation C(t) into the Franck-Condon spectral density
    S(E) (`analysis.spectrum_from_correlation`), with the stderr band of
    an npz that carries `autocorrelation_stderr`. The output file is the
    task's `spectra`, else its alias `spectrum`, else the input."""
    from semiclassical_tpu_torch.analysis import (fourier_stderr,
                                                  spectrum_from_correlation)

    broad, hwhmG, hwhmL, lineshape = _build_lineshape(task)
    corr_file = task.get("correlations", "correlations.npz")
    out_file = task.get("spectra", task.get("spectrum", corr_file))

    logger.info(f"compute the spectrum from the autocorrelation "
                f"in '{corr_file}'")
    data = dict(np.load(corr_file))
    _log_time_grid(data)
    energies, spectrum = spectrum_from_correlation(
        data["times"], data["autocorrelation"], lineshape)

    data["spectrum_broadening"] = broad
    data["spectrum_hwhmG"] = hwhmG
    data["spectrum_hwhmL"] = hwhmL
    data["spectrum_energies"] = energies
    data["spectrum"] = spectrum.real

    if "autocorrelation_stderr" in data:
        sigma = fourier_stderr(data["times"], data["autocorrelation_stderr"],
                               lineshape)
        data["spectrum_stderr"] = sigma
        logger.info(f"spectrum MC stderr (per energy point): {sigma:.3e}")

    # S integrates to f~(0) C(0) ~ 1 for a normalised, converged ensemble
    s = spectrum.real
    total = float(np.sum(0.5 * (s[1:] + s[:-1]) * np.diff(energies)))
    logger.info(f"spectrum normalization integral S(E) dE = {total:.6f} "
                f"(~1 for a normalized wavepacket)")
    logger.info(f"the spectrum is saved to '{out_file}'")
    np.savez(out_file, **data)


if __name__ == "__main__":
    sys.exit(main())
