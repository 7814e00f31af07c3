# coding: utf-8
"""`semi-torch` — the port's command-line task runner.

The same user contract as `semi` (semiclassical_tpu.cli): JSON input
documents of the form {"semi": [task, ...]}, the same task keywords and the
same `.npz` accumulation semantics:

    python -m semiclassical_tpu_torch.cli dynamics input.json [--device cuda]
        [--trace trace.json]
    python -m semiclassical_tpu_torch.cli rates input.json
    python -m semiclassical_tpu_torch.cli spectrum input.json
    python -m semiclassical_tpu_torch.cli plot correlations.npz [--save f.png]
    python -m semiclassical_tpu_torch.cli export correlations.npz
    python -m semiclassical_tpu_torch.cli show correlations.npz

`dynamics` runs on the device named by `--device` (default `cuda`); it
raises when that device is not available and never moves to another one.
Scale-out comes in two modes, as in the JAX package:

* a process group (`--coordinator host:port --num-processes n
  --process-id k`, or the SEMI_COORDINATOR / SEMI_NUM_PROCESSES /
  SEMI_PROCESS_ID environment): one process per device (NCCL on the
  cards, gloo with `--device cpu`) whose ranks share every batch — each
  draws the whole batch and propagates its own rows, the batch sums are
  added over the group, and rank 0 alone writes the npz and logs the
  progress and norms (`semiclassical_tpu_torch.parallel`). `--devices n`
  with n > 1 is refused: the port runs one process per device;
* accumulation mode (SEMI_PROCESS_ID without a coordinator): independent
  processes merge their own batches into one npz through its file lock;
  `results.overwrite` is forced to false and the rank is folded into the
  seed of every repetition (`_repetition_seed`).

`--trace FILE` runs the tasks under `torch.profiler` and writes the
session's Chrome trace to FILE; the log then adds the time loop's ms a
step by section and the host reads (`profiling`).

`--precision` selects the numerical mode of the JAX package ("f64", the
default on every device, "mixed", "comp32" or "f32"; see `PRECISIONS`).
Task keywords outside the ported slice (other propagators or potential
types, unknown names) raise `ConfigurationError` naming them, rather than
being ignored. The checkpoints of `checkpoint` are the port's own format
(`semiclassical_tpu_torch.checkpoint`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os.path
import sys

import numpy as np

from semiclassical_tpu_torch.config import ConfigurationError, validate_task
from semiclassical_tpu_torch.propagation.eom import HESSIAN_EVAL_MODES
from semiclassical_tpu_torch.sampling import SAMPLING_METHODS

logger = logging.getLogger(__name__)

__all__ = ["main", "run_semiclassical_dynamics", "calculate_rates",
           "calculate_spectrum", "check_slice", "ConfigurationError"]

# potential types of the ported slice
PORTED_POTENTIALS = ("harmonic", "anharmonic AS", "gdml")
INTEGRATORS = ("rk4", "exact")
# --precision: (dtype of the packs, the monodromy and the complex algebra,
# dtype of q, p and S) by name, the JAX package's modes
PRECISIONS = {"f64": ("float64", "float64"), "mixed": ("float32", "float64"),
              "comp32": ("float32", "comp32"), "f32": ("float32", "float32")}


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
        "--devices", type=int, default=1, metavar="n",
        help="devices of one process: the port runs one process per device "
             "(n > 1 is refused; launch n processes with --coordinator)")
    parser_dynamics.add_argument(
        "--coordinator", type=str,
        default=os.environ.get("SEMI_COORDINATOR", ""), metavar="host:port",
        help="rank 0's address of a process group whose ranks share every "
             "batch (or a torch.distributed init URL such as file://path); "
             "needs --num-processes and --process-id, or their SEMI_* envs")
    parser_dynamics.add_argument(
        "--num-processes", type=int,
        default=int(os.environ.get("SEMI_NUM_PROCESSES", "0")),
        help="number of processes of the group (with --coordinator)")
    parser_dynamics.add_argument(
        "--process-id", type=int,
        default=int(os.environ.get("SEMI_PROCESS_ID", "-1")),
        help="rank of this process in the group (with --coordinator)")
    parser_dynamics.add_argument(
        "--precision", type=str, default="f64",
        help="numerical mode: f64 (float64/complex128 end to end, the "
             "default), mixed (float32/complex64 monodromy and complex "
             "algebra, float64 trajectories), comp32 (mixed with float32 "
             "trajectories and Neumaier residuals) or f32 (float32 "
             "throughout)")
    parser_dynamics.add_argument(
        "--trace", type=str, default="", metavar="FILE",
        help="run the task under torch.profiler and write its Chrome trace "
             "to FILE (one file a rank of a group); the log then gives the "
             "time loop's ms a step by section and the host reads")

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

    parser_plot = subparsers.add_parser(
        "plot", help="plot correlation and rate functions from .npz files "
                     "(needs matplotlib)")
    parser_plot.add_argument("correlation_files", type=str, nargs="+",
                             metavar="correlations.npz")
    parser_plot.add_argument(
        "--save", type=str, default="", metavar="figure.png",
        help="write the figure to this file (Agg backend, no display "
             "needed) instead of opening a window")

    parser_export = subparsers.add_parser(
        "export",
        help="export correlation functions and rates from .npz to .dat "
             "tables (autocorrelation.dat, ic_correlation.dat, ic_rate.dat, "
             "spectrum.dat)")
    parser_export.add_argument("correlation_file", type=str,
                               metavar="correlations.npz")

    parser_show = subparsers.add_parser(
        "show", help="show information about a .npz results file")
    parser_show.add_argument("correlation_file", type=str,
                             metavar="correlations.npz")

    args = parser.parse_args(argv)
    logging.basicConfig(format="[%(module)-12s] %(message)s",
                        level=logging.INFO)

    if args.command == "dynamics":
        if args.devices > 1:
            raise ConfigurationError(
                f"--devices {args.devices}: the port runs one process per "
                "device; launch one process per device with --coordinator "
                "host:port --num-processes n --process-id k")
        tasks = _load_tasks(args.json_input, "dynamics")
        group = None
        if args.coordinator:
            from semiclassical_tpu_torch.parallel import init_group

            group = init_group(args.coordinator, args.num_processes,
                               args.process_id, args.device)
            logger.info(f"process group: rank {group.rank} of {group.world}"
                        f" on {group.device} via {args.coordinator}")
        try:
            for task in tasks:
                check_slice(task, args.precision, group)
            from semiclassical_tpu_torch import profiling
            from semiclassical_tpu_torch.parallel import rank_path

            device = args.device if group is None else group.device
            with (profiling.trace_to(
                    rank_path(args.trace, None if group is None
                              else group.rank), device)
                  if args.trace else contextlib.nullcontext()):
                for task in tasks:
                    run_semiclassical_dynamics(
                        task, device=device, precision=args.precision,
                        group=group)
        finally:
            from semiclassical_tpu_torch.parallel import destroy_group

            destroy_group(group)
    elif args.command in ("rates", "spectrum"):
        if not args.json_input.endswith(".json"):
            raise ConfigurationError(
                f"The argument for the command '{args.command}' should be the "
                f"JSON control file, got '{args.json_input}' instead.")
        run = calculate_rates if args.command == "rates" else \
            calculate_spectrum
        for task in _load_tasks(args.json_input, args.command):
            run(task)
    elif args.command == "plot":
        _plot_correlation_functions(args.correlation_files, save=args.save)
    elif args.command == "export":
        _export_tables(args.correlation_file)
    elif args.command == "show":
        _show_information(args.correlation_file)
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


def check_slice(task, precision="f64", group=None):
    """Raise ConfigurationError, naming the keyword, for a dynamics task
    that asks for anything outside the ported slice (HK, or WM with
    `cell_width`; the molecular harmonic PES, the anharmonic AS model and
    the sGDML PES, the latter with `hess_dtype` and `eg_mode`; the
    precision modes of `PRECISIONS`), and validate up front the names of
    the integrator and of `hessian_eval` and the statistics keywords
    `sampling`, `micro_batch`, `calc_norm_every` and `norm_samples` (the
    subsampled norm runs on a single process only: under a process `group`
    the norm is the ring over every pair)."""
    if precision not in PRECISIONS:
        raise ConfigurationError(
            f"precision '{precision}' is unknown (expected one of "
            + ", ".join(f"'{m}'" for m in PRECISIONS) + ")")
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
    if hessian_eval not in HESSIAN_EVAL_MODES:
        raise ConfigurationError(
            f"hessian_eval '{hessian_eval}' is unknown (expected one of "
            + ", ".join(f"'{m}'" for m in HESSIAN_EVAL_MODES) + ")")
    integrator = task.get("integrator", "rk4")
    if integrator not in INTEGRATORS:
        raise ConfigurationError(
            f"integrator '{integrator}' is unknown (expected 'rk4' or "
            "'exact')")
    for key in ("micro_batch", "calc_norm_every", "norm_samples"):
        value = task.get(key, 0)
        if isinstance(value, bool) or not isinstance(value, int) or value < 0:
            raise ConfigurationError(
                f"task keyword '{key}' should be a non-negative int, got "
                f"{value!r}")
    if group is not None and task.get("norm_samples", 0):
        raise ConfigurationError(
            "task keyword 'norm_samples' (the subsampled norm) runs on a "
            "single process only; under a process group the norm is the "
            "ring over every pair (drop norm_samples)")
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
    """(potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap, atomic_numbers)
    from the task's `potential` section. For the molecular PES (harmonic,
    gdml) the energy origin is moved to the minimum of the final PES, the
    wavepacket is the vibrational ground state of the excited-state fchk
    and the atomic numbers are that fchk's; the AS model has no adiabatic
    gap (NaN) and no atoms (None)."""
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
        potential = MorsePotential.create(
            omega, chi, nac, device=device,
            hessian_eval=p.get("hessian_eval", "stage"),
            taylor_every=p.get("taylor_every", 1))
        if potential.hessian_eval != "stage":
            logger.info("  hessian_eval                              : "
                        f"{potential.hessian_eval}"
                        + (f" (re-expansion every {potential.taylor_every}"
                           " steps)" if potential.taylor_every > 1 else ""))
        return (potential, dQ, 0.0 * dQ, np.diag(omega),
                float(np.sum(0.5 * omega)), np.nan, None)
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
    return (potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap,
            excited_fchk.atomic_numbers())


def _repetition_seed(seed, repetition, rank=None):
    """Seed of the repetition's generator: independent streams per
    repetition from one root seed, and per rank of an accumulation-mode
    run (`rank` folded in: SeedSequence([seed, rank, repetition])), so
    processes that share a `manual_seed` draw different batches."""
    entropy = [seed, repetition] if rank is None else [seed, rank,
                                                       repetition]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def _multiprocess_rank():
    """(is_multiprocess, rank) of this process in an accumulation-mode
    run: independent processes that share the results npz, each with its
    rank in SEMI_PROCESS_ID (the JAX package's coordinator-less mode). A
    process group (`--coordinator`) is not this mode: its ranks share each
    batch."""
    env = os.environ.get("SEMI_PROCESS_ID")
    if env is not None:
        return True, int(env)
    return False, 0


def _precision_dtypes(precision):
    """(dtype, traj_dtype) of a `--precision` name for the propagators."""
    import torch

    dtype, traj = PRECISIONS[precision]
    return getattr(torch, dtype), (traj if traj == "comp32"
                                   else getattr(torch, traj))


def _reduced_potential(potential, dtype):
    """The potential in the precision mode's form: a separable model's
    parameters at `dtype` (its PES evaluates at float32 in the reduced
    modes), the molecular harmonic PES with float32 contractions when
    `dtype` is float32; an sGDML PES keeps its own `hess_dtype`."""
    import torch

    from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                    MorsePotential,
                                                    NonHarmonicPotential)

    if isinstance(potential, (MorsePotential, NonHarmonicPotential)):
        return potential.to_dtype(dtype)
    if (isinstance(potential, MolecularHarmonicPotential)
            and dtype == torch.float32):
        return dataclasses.replace(potential, contract_dtype=torch.float32)
    return potential


def run_semiclassical_dynamics(task, device="cuda", precision="f64",
                               group=None):
    """Run one `dynamics` task at the `precision` mode (see `PRECISIONS`);
    returns the PhaseTimer of the run. Under a process `group` (a
    `parallel.Group`; `device` its device) every rank calls this with the
    same task: the ranks share each batch, and rank 0 writes the npz."""
    import torch

    from semiclassical_tpu_torch import units
    from semiclassical_tpu_torch.checkpoint import (CheckpointedRun,
                                                    agree_on_resume)
    from semiclassical_tpu_torch.io.results import (accumulate_results,
                                                    init_results)
    from semiclassical_tpu_torch.parallel import (barrier, group_sum,
                                                  is_leader, rank_path,
                                                  world_of)
    from semiclassical_tpu_torch.profiling import PhaseTimer, RunMetrics
    from semiclassical_tpu_torch.propagation import (
        HermanKlukPropagator, WaltonManolopoulosPropagator)

    check_slice(task, precision, group)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device 'cpu' (--device cpu) to run "
            "on the CPU explicitly")

    (potential, q0, p0, Gamma_0, en_zpt, adiabatic_gap,
     atomic_numbers) = _build_potential(task, device)
    if (task["potential"]["type"] == "gdml"
            and precision in ("comp32", "f32")):
        # the JAX package's warning, word for word
        logger.warning(
            f"--precision {precision} with a gdml potential is "
            "unvalidated: sGDML regression sums are cancellation-bound "
            "and were measured to need f64 energies/gradients — use "
            "'mixed' (default) and the potential's hess_dtype keyword "
            "for the validated reduced-precision mode")
    logger.info(f"  numerical precision                       : {precision}")
    dtype, traj_dtype = _precision_dtypes(precision)
    potential = _reduced_potential(potential, dtype)
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
    integrator = task.get("integrator", "rk4")
    logger.info(f"  integrator                                : {integrator}")
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
    leader = is_leader(group)
    # accumulation mode: cooperating processes merge their own batches
    # into one npz through its file lock, with the rank folded into the
    # seed, so a shared manual_seed still gives each its own batches
    multiproc, rank = (False, 0) if group is not None else \
        _multiprocess_rank()
    if multiproc and overwrite:
        # a rank that resets the shared npz mid-run would drop every other
        # rank's batches: accumulate instead
        logger.warning("multi-process run: results.overwrite forced to "
                       "false (delete the old npz before launching)")
        overwrite = False
    if (seed is not None and not overwrite and os.path.exists(filename)
            and not multiproc):
        raise ConfigurationError(
            "Multiple runs with the same sequence of random numbers make no "
            "sense! Do not use `manual_seed` and `overwrite=False` at the "
            "same time")
    # the files each process writes on its own: one per rank of a group or
    # of an accumulation-mode run
    own_rank = (group.rank if group is not None
                else rank if multiproc else None)
    # mid-batch checkpoint/resume: with `checkpoint` set, each repetition
    # saves its state every `checkpoint_every` steps; a killed run loses
    # at most one segment and resumes where the checkpoint stands (every
    # rank of a group at once, or none)
    ckpt_base = task.get("checkpoint", "")
    ckpt_file = rank_path(ckpt_base, own_rank)
    ckpt_every = task.get("checkpoint_every", 500)
    resume_rep = None
    resume_steps_done = 0
    meta = agree_on_resume(ckpt_file, group)
    if meta is not None:
        resume_rep = int(meta.get("repetition", 0))
        resume_steps_done = int(meta.get("steps_done", 0))
        logger.info(f"found checkpoint '{ckpt_file}' at repetition "
                    f"{resume_rep + 1}, step {resume_steps_done} — "
                    "resuming (completed repetitions are already in "
                    f"'{filename}')")
    # WM: Filinov cell widths alpha = beta
    cell_width = task.get("cell_width", 10000.0)
    if leader:
        init_results(filename, propagator_name, times, adiabatic_gap,
                     en_zpt, overwrite=overwrite and resume_rep is None)
    barrier(group)
    if seed is None:
        seed = int(np.random.SeedSequence().entropy)
        if group is not None:
            # the ranks share each batch, so they share rank 0's seed (52
            # bits: exact through the float64 all-reduce)
            mine = torch.tensor(float(seed % 2**52) if leader else 0.0,
                                dtype=torch.float64, device=device)
            seed = int(group_sum([mine], group)[0])
    else:
        logger.warning("The random number generator should not be seeded "
                       "manually unless for debugging!")
    if multiproc:
        logger.info(f"multi-process accumulation: rank {rank} (folded into "
                    "the seed)")

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
        if not leader:
            return
        t_fs = times[min(done, nt) - 1] * units.autime_to_fs
        logger.info(f" time/fs= {t_fs:9.4f}  step {done}/{total}  "
                    f"|C(t)|= {abs(cauto_last):.6f}")

    ptimer = PhaseTimer(device)
    traj_steps = 0   # traj-steps propagated by this process
    for repetition in range(num_repetitions):
        if resume_rep is not None and repetition < resume_rep:
            continue
        logger.info(f"*** Repetition {repetition + 1} ***")
        generator = torch.Generator(device=device)
        generator.manual_seed(_repetition_seed(
            seed, repetition, rank if multiproc else None))
        if propagator_name == "WM":
            propagator = WaltonManolopoulosPropagator(
                Gamma_i, Gamma_t, cell_width, cell_width, device=device,
                integrator=integrator, dtype=dtype, traj_dtype=traj_dtype)
        else:
            propagator = HermanKlukPropagator(Gamma_i, Gamma_t,
                                              device=device,
                                              integrator=integrator,
                                              dtype=dtype,
                                              traj_dtype=traj_dtype)
        propagator.micro_batch = micro
        with ptimer.phase("sample"):
            propagator.initial_conditions(q0, p0, Gamma_0, potential,
                                          ntraj=num_samples,
                                          generator=generator,
                                          sampling_method=sampling_method,
                                          group=group)
        _export_trajectories(rank_path(task.get("export_initial", ""),
                                       own_rank),
                             atomic_numbers, propagator,
                             append=(repetition > 0))

        def _norm_log(step):
            # the ring norm of a group is a collective: every rank runs it
            t_fs = times[step] * units.autime_to_fs
            if norm_samples > 0:
                nrm, err = propagator.norm(sample_pairs=norm_samples,
                                           key=repetition)
                line = f"norm= {nrm:9.6f} +- {err:.6f}"
            else:
                line = f"norm= {propagator.norm():9.6f}"
            if leader:
                logger.info(f" time/fs= {t_fs:.4f}  {line}")

        err_c = err_k = None
        try:
            if ckpt_file:
                run = CheckpointedRun(
                    ckpt_file, propagator, potential, dt=dt, nt=nt,
                    energy0_es=en_zpt, segment=ckpt_every, chunk=scan_chunk,
                    repetition=repetition, progress=_progress,
                    error_bars=error_bars, norm_every=calc_norm_every,
                    norm_callback=_norm_log)
                # the stderr comes back None when a resumed checkpoint was
                # written without error bars
                with ptimer.phase("scan"):
                    cauto, kic, err_c, err_k = run.run()
            elif calc_norm_every > 0:
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
                        err_c[done:done + seg] = out[2]
                        err_k[done:done + seg] = out[3]
                    done += seg
            else:
                with ptimer.phase("scan"):
                    out = propagator.propagate(
                        potential, dt, nt, energy0_es=en_zpt,
                        chunk=scan_chunk, progress=_progress,
                        error_bars=error_bars)
                cauto, kic = out[:2]
                if error_bars:
                    err_c, err_k = out[2:]
            # the energy guard inside propagate raises for NaN
            # trajectories; this catches NaN prefactors and observables
            if np.isnan(cauto).any() or np.isnan(kic).any():
                raise RuntimeError("encountered NaN's in correlations")
        except RuntimeError:
            # NaN watchdog: the trajectories as they stand, for debugging
            if atomic_numbers is not None:
                logger.info("NaN's/instability detected, saving trajectories "
                            "to 'current_trajectories.xyz' for debugging ...")
                _export_trajectories(
                    rank_path("current_trajectories.xyz", own_rank),
                    atomic_numbers, propagator, append=False)
            raise
        _export_trajectories(rank_path(task.get("export_final", ""),
                                       own_rank),
                             atomic_numbers, propagator,
                             append=(repetition > 0))
        RunMetrics.from_run(propagator.last_energies, cauto, kic).log()
        # every rank has written its last checkpoint of the batch
        barrier(group)
        if leader:
            # removed before accumulating: a kill between the two loses
            # this batch but can never count it twice on resume
            for r in ([own_rank] if group is None
                      else range(group.world)):
                done_file = rank_path(ckpt_base, r)
                if done_file and os.path.exists(done_file):
                    os.remove(done_file)
            with ptimer.phase("reduce"):
                total = accumulate_results(filename, cauto, kic,
                                           propagator.ntraj,
                                           autocorrelation_stderr=err_c,
                                           ic_correlation_stderr=err_k)
            logger.info(f"  accumulated trajectories: {total}")
            if err_c is not None:
                logger.info(f"  MC stderr: |C(t)| max {err_c.max():.2e}, "
                            f"k~ic max {err_k.max():.2e}")
        barrier(group)
        steps_run = nt
        if repetition == resume_rep:
            steps_run = max(nt - resume_steps_done, 0)
        traj_steps += propagator.ntraj * steps_run
    ptimer.log(traj_steps, nchips=world_of(group))
    return ptimer


def _export_trajectories(filename, atomic_numbers, propagator, append=False):
    """Write the current positions and momenta as extended XYZ (molecular
    potentials only: the AS model has no atoms)."""
    if filename == "" or atomic_numbers is None:
        return
    from semiclassical_tpu_torch.io.extxyz import write_extxyz

    q, p = propagator.current_positions_and_momenta()
    write_extxyz(filename, atomic_numbers, q.cpu().numpy(), p.cpu().numpy(),
                 append=append)
    logger.info(f"positions and momenta saved to '{filename}'")


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


def _export_tables(filename):
    """Export correlations, rates and the spectrum to .dat tables in the
    working directory."""
    from semiclassical_tpu_torch import units

    data = np.load(filename)
    trajectories = int(data["trajectories"])
    propagator = str(data["propagator"])

    logger.info(f"exporting correlation functions from '{filename}' to "
                "tables 'autocorrelation.dat' and 'ic_correlation.dat'")
    with open("autocorrelation.dat", "w") as f:
        f.write("# autocorrelation function\n")
        f.write(f"# propagator: {propagator}   trajectories: "
                f"{trajectories}\n")
        f.write(f"# zero-point energy: "
                f"{data['zero_point_energy'] * units.hartree_to_wavenumbers:.2f} cm-1\n")
        f.write("#\n")
        f.write("# Time/fs                  Re[C(t)]                  "
                "Im[C(t)]\n")
        np.savetxt(f, np.vstack((data["times"] * units.autime_to_fs,
                                 data["autocorrelation"].real,
                                 data["autocorrelation"].imag)).T)
    with open("ic_correlation.dat", "w") as f:
        f.write("# IC-correlation function\n")
        f.write(f"# propagator: {propagator}   trajectories: "
                f"{trajectories}\n")
        f.write("#\n")
        f.write("# Time/fs                  Re[kIC(t)]                "
                "Im[kIC(t)]\n")
        np.savetxt(f, np.vstack((data["times"] * units.autime_to_fs,
                                 data["ic_correlation"].real,
                                 data["ic_correlation"].imag)).T)
    if "ic_rate" in data:
        logger.info(f"exporting IC rates from '{filename}' to 'ic_rate.dat'")
        with open("ic_rate.dat", "w") as f:
            f.write("# internal conversion rate\n")
            f.write(f"# propagator: {propagator}   trajectories: "
                    f"{trajectories}\n")
            f.write(f"# broadening: {data['broadening']}   HWHM_G: "
                    f"{data['hwhmG']} eV   HWHM_L: {data['hwhmL']} eV\n")
            f.write(f"# tmin: {data['times'].min() * units.autime_to_fs:.4f} "
                    f"fs  tmax: {data['times'].max() * units.autime_to_fs:.4f}"
                    f" fs  steps= {len(data['times'])}\n")
            f.write("#\n")
            f.write("# Energy/eV                kIC(E)/s^-1\n")
            np.savetxt(f, np.vstack((data["energies"] * units.hartree_to_ev,
                                     data["ic_rate"].real)).T)
    if "spectrum" in data:
        logger.info(f"exporting the spectrum from '{filename}' to "
                    "'spectrum.dat'")
        with open("spectrum.dat", "w") as f:
            f.write("# Franck-Condon spectral density S(E) of the "
                    "wavepacket autocorrelation\n")
            f.write(f"# propagator: {propagator}   trajectories: "
                    f"{trajectories}\n")
            f.write(f"# broadening: {data['spectrum_broadening']}   HWHM_G: "
                    f"{data['spectrum_hwhmG']} eV   HWHM_L: "
                    f"{data['spectrum_hwhmL']} eV\n")
            f.write("# energies are relative to the initial-state "
                    "zero-point energy\n")
            f.write("#\n")
            f.write("# Energy/eV                S(E)/(1/Hartree)\n")
            np.savetxt(f, np.vstack(
                (data["spectrum_energies"] * units.hartree_to_ev,
                 data["spectrum"].real)).T)


def _plot_correlation_functions(filenames, save=""):
    """Render C(t), k~ic(t) and k_IC(E) for one or more results files.

    The rate at the adiabatic gap is marked with an annotated point, and
    each file's propagator and trajectory count ride in its legend entry.
    With `save` the figure goes to a file (forcing the Agg backend, so it
    works without a display) instead of an interactive window. Needs
    matplotlib, imported here only.
    """
    from semiclassical_tpu_torch import units

    if save:
        import matplotlib
        matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    fig, (ax_auto, ax_ic, ax_rate) = plt.subplots(
        1, 3, figsize=(13.0, 5.0))

    for filename in filenames:
        data = np.load(filename)
        t_fs = data["times"] * units.autime_to_fs
        tag = (f"{filename} [{data['propagator']}, "
               f"{int(data['trajectories'])} traj]")

        for ax, key in ((ax_auto, "autocorrelation"),
                        (ax_ic, "ic_correlation")):
            curve = data[key]
            line, = ax.plot(t_fs, curve.real, label=f"Re {tag}")
            ax.plot(t_fs, curve.imag, ls="--", alpha=0.6,
                    color=line.get_color(), label=f"Im {tag}")
            # Monte-Carlo error band (error_bars task keyword): the stderr
            # of the complex mean, drawn around the real part
            if key + "_stderr" in data:
                err = data[key + "_stderr"]
                ax.fill_between(t_fs, curve.real - err, curve.real + err,
                                color=line.get_color(), alpha=0.2, lw=0)

        if "ic_rate" in data:
            en_ev = data["energies"] * units.hartree_to_ev
            line, = ax_rate.plot(en_ev, data["ic_rate"], label=tag)
            # the propagated MC band is one scalar for the whole curve
            # (fourier_stderr); on the log axis a 0 lower edge would render
            # down to the axis floor and swamp the tails, so mask the band
            # wherever the curve falls below the stderr
            if "ic_rate_stderr" in data:
                err = float(data["ic_rate_stderr"])
                lower = data["ic_rate"] - err
                lower = np.where(lower > 0.0, lower, np.nan)
                ax_rate.fill_between(
                    en_ev, lower, data["ic_rate"] + err,
                    color=line.get_color(), alpha=0.2, lw=0)
            gap = float(data["adiabatic_gap"])
            if np.isfinite(gap):
                idx = int(np.argmin(np.abs(data["energies"] - gap)))
                kic = data["ic_rate"][idx]
                ax_rate.plot([gap * units.hartree_to_ev], [kic], "o",
                             color=line.get_color())
                ax_rate.annotate(
                    f"{kic:.2e}" r" s$^{-1}$",
                    (gap * units.hartree_to_ev, kic),
                    textcoords="offset points", xytext=(6, 6),
                    fontsize=9, color=line.get_color())

    ax_auto.set_title("autocorrelation")
    ax_auto.set_xlabel("time / fs")
    ax_auto.set_ylabel(r"$e^{i E_0^{(es)} t / \hbar}"
                       r"\,\langle\phi(0)|\phi(t)\rangle$")
    ax_ic.set_title("IC correlation")
    ax_ic.set_xlabel("time / fs")
    ax_ic.set_ylabel(r"$\tilde{k}_{IC}(t)$")
    ax_ic.legend(fontsize=8)
    ax_rate.set_title("IC rate (dot: at adiabatic gap)")
    ax_rate.set_xlabel("energy gap / eV")
    ax_rate.set_ylabel(r"$k_{IC}(E)$ / s$^{-1}$")
    ax_rate.set_yscale("log")
    ax_rate.set_xlim(0.0, 10.0)
    if ax_rate.get_legend_handles_labels()[0]:
        ax_rate.legend(fontsize=8)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=150)
        print(f"figure written to {save}")
    else:
        plt.show()


def _show_information(filename):
    """Print a summary of a results file."""
    from semiclassical_tpu_torch import units

    data = np.load(filename)
    print(f"""
    filename                 : {filename}
    propagator               : {data['propagator']}
    trajectories             : {int(data['trajectories']):10}
    time step (fs)           : {(data['times'][1] - data['times'][0]) * units.autime_to_fs:10.4f}
    propagation time (fs)    : {max(data['times']) * units.autime_to_fs:10.4f}
    zero-point energy (cm-1) : {float(data['zero_point_energy']) * units.hartree_to_wavenumbers:10.4f}
    """)
    if "ic_rate" in data:
        if not np.isnan(data["adiabatic_gap"]):
            iclosest = np.argmin(abs(data["energies"] - data["adiabatic_gap"]))
            kic = data["ic_rate"][iclosest]
        else:
            kic = np.nan
        print(f"""
    adiabatic gap Ead (eV)   : {float(data['adiabatic_gap']) * units.hartree_to_ev:6.3f}
    IC rate kic(Ead) (s-1)   : {kic:6.3e}
        """)
        imax = np.argmax(data["ic_rate"])
        print(f"""
    position of maximum (eV) : {data['energies'][imax] * units.hartree_to_ev:6.3f}
    maximum of IC rate (s-1) : {data['ic_rate'][imax]:6.3e}
        """)
        if "ic_rate_stderr" in data:
            print(f"    rate MC stderr (s-1)     : "
                  f"{float(data['ic_rate_stderr']):6.3e}")
        print("IC rates are only reliable around the maximum of the curve.")
    else:
        print("  No rates found in file, you have to compute them first "
              "with the command 'semi rates'.")
    if "spectrum" in data:
        en = data["spectrum_energies"]
        sp = data["spectrum"]
        imax = np.argmax(sp)
        total = float(np.trapezoid(sp, en))
        print(f"""
    spectrum maximum (eV, rel. ZPE) : {en[imax] * units.hartree_to_ev:6.3f}
    spectrum integral (~1)          : {total:8.5f}
        """)
        if "spectrum_stderr" in data:
            print(f"    spectrum MC stderr (1/Ha)       : "
                  f"{float(data['spectrum_stderr']):6.3e}")


if __name__ == "__main__":
    sys.exit(main())
