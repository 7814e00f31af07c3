# coding: utf-8
"""Rank programs of the port's process-group tests (imported by spawned
ranks, so it imports torch and the port only).

`spawn(world, job_names, out_dir, ...)` starts `world` ranks with
torch.multiprocessing's `spawn` method, each pinned to one intra-op
thread, on a gloo group initialised through a `file://` store in
`out_dir` (no TCP port for concurrent test workers to race for). Each rank
runs the named jobs with its group and saves what they return to
`out_dir/rank{r}.npz` as "job/key" entries. Every job is also called with
group None by the tests: the single-process reference at the same seed.
A rank that does not finish within the timeout fails the test.
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np
import torch

from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch import checkpoint as port_checkpoint
from semiclassical_tpu_torch.coherent import OverlapParams
from semiclassical_tpu_torch.parallel import (destroy_group, init_group,
                                              rank_path, shard_rows)
from semiclassical_tpu_torch.potentials import (MorsePotential,
                                                NonHarmonicPotential)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator,
                                                 hk)

RANK_TIMEOUT = 120.0   # seconds: each collective, and the store's rendezvous
JOIN_TIMEOUT = 300.0   # seconds: a whole spawn


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _out(prop, res):
    """The propagate result as a dict, with the batch size."""
    keys = ("c", "k", "ec", "ek")
    return dict(zip(keys, res), ntraj=np.asarray(prop.ntraj))


# ---------------------------------------------------------------------------
# jobs: job(group, **kwargs) -> {key: array}
# ---------------------------------------------------------------------------

def _nonharmonic(group, cls, ntraj, args=()):
    pot = NonHarmonicPotential.create(device="cpu")
    Gi, G0 = np.array([[5.0]]), np.array([[1.0]])
    prop = cls(Gi, Gi, *args, device="cpu")
    prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0, pot,
                            ntraj=ntraj, generator=_gen(7), group=group)
    return prop, pot


def job_hk_1d(group, ntraj=1001):
    """test_sharding.py's 1D HK and its non-divisible ntraj: 25 steps in
    segments of 10, with error bars."""
    prop, pot = _nonharmonic(group, HermanKlukPropagator, ntraj)
    return _out(prop, prop.propagate(pot, 0.02, 25, energy0_es=0.5,
                                     chunk=10, error_bars=True))


def job_wm_1d(group, ntraj=1001):
    """The same with WM (alpha = beta = 100)."""
    prop, pot = _nonharmonic(group, WaltonManolopoulosPropagator, ntraj,
                             (100.0, 100.0))
    return _out(prop, prop.propagate(pot, 0.02, 25, energy0_es=0.5,
                                     chunk=10, error_bars=True))


def _morse_model(d, seed, zero_modes=0):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(0.005, 0.02, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    q0 = rng.uniform(0.5, 1.5, size=d)
    z = np.zeros(zero_modes)
    omega, nac, q0 = (np.concatenate([x, z]) for x in (omega, nac, q0))
    return omega, nac, q0


def job_rank_deficient(group, ntraj=256):
    """test_sharding.py's rank-deficient case: 4 modes + 2 zero modes
    (singular widths, the dense path), HK and WM."""
    omega, nac, q0 = _morse_model(4, 1, zero_modes=2)
    pot = MorsePotential.create(omega, np.full(6, 0.02), nac, device="cpu")
    G = np.diag(omega)
    out = {}
    for name, cls, args in (("hk", HermanKlukPropagator, ()),
                            ("wm", WaltonManolopoulosPropagator,
                             (200.0, 200.0))):
        prop = cls(G, G, *args, device="cpu")
        prop.initial_conditions(q0, np.zeros(6), G, pot, ntraj=ntraj,
                                generator=_gen(11), group=group)
        c, k = prop.propagate(pot, 1.0, 10, energy0_es=0.01)
        out.update({f"{name}_c": c, f"{name}_k": k})
    return out


def job_multimode(group, ntraj=256):
    """test_sharding.py's 5-mode full-rank Morse with HK (the separable
    path), here with antithetic sampling, error bars and micro_batch 32."""
    omega, nac, q0 = _morse_model(5, 0)
    pot = MorsePotential.create(omega, np.full(5, 0.02), nac, device="cpu")
    G = np.diag(omega)
    prop = HermanKlukPropagator(G, G, device="cpu")
    prop.initial_conditions(q0, np.zeros(5), G, pot, ntraj=ntraj,
                            generator=_gen(3), sampling_method="antithetic",
                            group=group)
    return _out(prop, prop.propagate(pot, 1.0, 10, energy0_es=0.01, chunk=4,
                                     error_bars=True, micro_batch=32))


def job_sobol(group, ntraj=256):
    """The 5-mode HK with scrambled Sobol' draws (the scramble seed from
    the shared generator), with error bars."""
    omega, nac, q0 = _morse_model(5, 0)
    pot = MorsePotential.create(omega, np.full(5, 0.02), nac, device="cpu")
    G = np.diag(omega)
    prop = HermanKlukPropagator(G, G, device="cpu")
    prop.initial_conditions(q0, np.zeros(5), G, pot, ntraj=ntraj,
                            generator=_gen(9), sampling_method="sobol",
                            group=group)
    return _out(prop, prop.propagate(pot, 1.0, 10, energy0_es=0.01,
                                     error_bars=True))


def job_wm_separable(group, ntraj=256):
    """WM on the 5-mode model: the separable path (K5's plain version on
    the CPU), with error bars."""
    omega, nac, q0 = _morse_model(5, 0)
    pot = MorsePotential.create(omega, np.full(5, 0.02), nac, device="cpu")
    G = np.diag(omega)
    prop = WaltonManolopoulosPropagator(G, G, 200.0, 200.0, device="cpu")
    prop.initial_conditions(q0, np.zeros(5), G, pot, ntraj=ntraj,
                            generator=_gen(5), group=group)
    return _out(prop, prop.propagate(pot, 1.0, 10, energy0_es=0.01, chunk=4,
                                     error_bars=True))


def job_comp32(group, ntraj=256):
    """test_comp32.py's 12-mode AS model under comp32, 20 steps; with the
    shard's rows of the final state."""
    rng = np.random.default_rng(0)
    d = 12
    omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac, device="cpu",
                                dtype=torch.float32)
    G = np.diag(omega)
    prop = HermanKlukPropagator(G, G, device="cpu", dtype=torch.float32,
                                traj_dtype="comp32")
    prop.initial_conditions(np.sqrt(2 * S / omega), np.zeros(d), G, pot,
                            ntraj=ntraj, generator=_gen(11), group=group)
    out = _out(prop, prop.propagate(pot, 2.0, 20, check_energy=False))
    st = prop.state
    out.update(q=st.q.numpy(), qc=st.qc.numpy(), p=st.p.numpy(),
               S=st.S.numpy(), rows=np.asarray(shard_rows(prop.ntraj, group)))
    return out


# global rows made hot (unbound / near-separatrix) before the exact run:
# they fall on every rank's shard at worlds 2 and 4
HOT_ROWS = (3, 70, 130, 200, 250)


def job_exact(group, ntraj=256):
    """test_exact_morse.py's sharded exact run (4-mode Morse, 10 steps),
    with the rows HOT_ROWS pushed above the separatrix so that the RK4
    side-channel holds rows on every shard; with error bars."""
    rng = np.random.default_rng(10)
    d = 4
    omega = rng.uniform(300.0, 2800.0, size=d) / 219474.63
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac, device="cpu")
    G = np.diag(omega)
    prop = HermanKlukPropagator(G, G, device="cpu", integrator="exact")
    prop.initial_conditions(np.sqrt(2 * S / omega), np.zeros(d), G, pot,
                            ntraj=ntraj, generator=_gen(5), group=group)
    a, b = shard_rows(prop.ntraj, group)
    p = prop.state.p.clone()
    for row in HOT_ROWS:
        if a <= row < b:
            p[row - a, 0] = float(np.sqrt(2.4 * float(pot.D[0])))
    prop.state = dataclasses.replace(prop.state, p=p)
    out = _out(prop, prop.propagate(pot, 2.0, 10, error_bars=True))
    sub = prop._morse.pack.sub_idx
    out["routed_here"] = np.asarray(0 if sub is None else sub.numel())
    return out


def ring_arrays(n, d=3, seed=21):
    """(Gamma, q, p, log_re, log_im) of a batch of n random coherent
    states: the inputs both packages' rings take."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d))
    G = A @ A.T / d + 0.5 * np.eye(d)
    q, p = 0.4 * rng.standard_normal((2, n, d))
    return (G, q, p, rng.standard_normal(n) - 3.0,
            rng.uniform(-3.0, 3.0, n))


def job_ring(group, n=96, block=8):
    """The ring pair sum of the HK log-coefficient block term over
    `ring_arrays(n)` (this rank's rows), blocks of `block`."""
    G, *arrays = ring_arrays(n)
    ov = OverlapParams.create(G, G, "cpu")
    a, b = shard_rows(n, group)
    t = [torch.from_numpy(x[a:b]) for x in arrays]
    if group is None:
        total = hk.blocked_pair_sum(hk._hk_norm_log_block_term, ov, t, block,
                                    hermitian=False)
    else:
        total = hk._pair_sum_ring(hk._hk_norm_log_block_term, ov, t, group,
                                  block)
    return {"norm2": np.asarray(total)}


def _norm_hk(group, G, q0, pot, ntraj=512):
    prop = HermanKlukPropagator(G, G, device="cpu")
    prop.initial_conditions(q0, np.zeros(q0.size), G, pot, ntraj=ntraj,
                            generator=_gen(5), group=group)
    prop.propagate(pot, 1.0, 8, energy0_es=0.05)
    return prop


def job_norms(group):
    """test_norm_device.py's ring tests: the HK log norm, the linear HK
    norm with blocks of 32 inside a shard, the WM norm, and the HK pair
    sum at rank-deficient widths over the ordered grid; whether a
    subsampled norm raises; C(t), k~ic(t) and the grid wavefunction of
    the HK and WM propagators' accessors."""
    rng = np.random.default_rng(1)
    omega = rng.uniform(0.004, 0.01, size=3)
    pot = MorsePotential.create(omega, np.full(3, 0.02),
                                rng.uniform(-1.0, 1.0, size=3), device="cpu")
    G = np.diag(omega)
    q0 = np.full(3, 0.2)
    prop = _norm_hk(group, G, q0, pot)
    out = {"hk_log": np.asarray(prop.norm())}
    # the granular accessors of the batch at the current state
    grid = q0[None, :] + 0.3 * np.random.default_rng(4).standard_normal(
        (5, 3))
    out.update(auto=np.asarray(prop.autocorrelation(0.05)),
               kic=np.asarray(prop.ic_correlation(pot, 0.05)),
               psi=prop.wavefunction(grid))
    v = prop.coefficients()
    out["hk_linear"] = np.asarray(hk.pairwise_norm(
        prop.params.csott, prop.state.q, prop.state.p, v, block=32,
        group=group))

    wprop = WaltonManolopoulosPropagator(G, G, 500.0, 500.0, device="cpu")
    wprop.initial_conditions(q0, np.zeros(3), G, pot, ntraj=256,
                             generator=_gen(5), group=group)
    wprop.propagate(pot, 1.0, 8, energy0_es=0.05)
    out["wm"] = np.asarray(wprop.norm(block=32))
    out.update(wm_auto=np.asarray(wprop.autocorrelation(0.05)),
               wm_kic=np.asarray(wprop.ic_correlation(pot, 0.05)),
               wm_psi=wprop.wavefunction(grid))

    omega6, nac6, q06 = _morse_model(4, 1, zero_modes=2)
    pot6 = MorsePotential.create(omega6, np.full(6, 0.02), nac6,
                                 device="cpu")
    p6 = _norm_hk(group, np.diag(omega6), q06, pot6, ntraj=256)
    arrays = (p6.state.q, p6.state.p, *p6._log_coefficients())
    out["hk_deficient"] = np.asarray(hk._pair_sum(
        hk._hk_norm_log_block_term, p6.params.csott, arrays, 32, group,
        hermitian=False))
    try:
        prop.norm(sample_pairs=4)
        out["sampled_raises"] = np.asarray(False)
    except ValueError:
        out["sampled_raises"] = np.asarray(True)
    return out


def job_checkpoint(group, path):
    """test_checkpoint.py's restore onto a sharded run, per rank: 12 steps,
    a checkpoint of this rank's rows into its own file, a fresh batch of
    another seed restored from it, then 13 more steps. Returns C(t),
    k~ic(t) of the 13 steps and the uninterrupted 25 steps'."""
    pot = NonHarmonicPotential.create(device="cpu")
    Gi, G0 = np.array([[5.0]]), np.array([[1.0]])

    def make(seed):
        prop = HermanKlukPropagator(Gi, Gi, device="cpu")
        prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0, pot,
                                ntraj=512, generator=_gen(seed), group=group)
        return prop

    whole = make(5).propagate(pot, 0.02, 25, energy0_es=0.5)
    prop = make(5)
    prop.propagate(pot, 0.02, 12, energy0_es=0.5)
    fname = rank_path(str(path), None if group is None else group.rank)
    port_checkpoint.save_propagator_state(fname, prop)
    resumed = make(9)
    port_checkpoint.load_propagator_state(fname, resumed)
    c, k = resumed.propagate(pot, 0.02, 13, energy0_es=0.5)
    return {"c": c, "k": k, "whole_c": whole[0], "whole_k": whole[1]}


def job_checkpoint_other_world(group, path):
    """Resume decision on checkpoints written by a group of another size:
    every rank raises naming 'meta/world'."""
    try:
        port_checkpoint.agree_on_resume(rank_path(str(path), group.rank),
                                        group)
    except ValueError as exc:
        return {"message": np.asarray(str(exc))}
    return {"message": np.asarray("")}


JOBS = {name[len("job_"):]: fn for name, fn in globals().items()
        if name.startswith("job_")}


# ---------------------------------------------------------------------------
# the CLI under a group
# ---------------------------------------------------------------------------

class Killed(Exception):
    """Raised from the checkpoint writer to stop a run after a write."""


class LogLines(logging.Handler):
    """Collects the messages of the port's loggers while active."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        root = logging.getLogger("semiclassical_tpu_torch")
        self.level = root.level
        root.addHandler(self)
        root.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        root = logging.getLogger("semiclassical_tpu_torch")
        root.removeHandler(self)
        root.setLevel(self.level)


def run_cli(rank, world, cfg, store, kill_after=None):
    """`cli.main` as rank `rank` of a group through the `file://` store;
    with `kill_after`, the run dies right after its kill_after-th
    checkpoint write. Returns the log lines of the port's loggers."""
    save = port_checkpoint.save_propagator_state
    calls = []

    def killing_save(*args, **kwargs):
        save(*args, **kwargs)
        calls.append(1)
        if len(calls) == kill_after:
            raise Killed

    port_checkpoint.save_propagator_state = killing_save
    log = LogLines()
    try:
        with log:
            cli.main(["dynamics", str(cfg), "--device", "cpu",
                      "--coordinator", f"file://{store}", "--num-processes",
                      str(world), "--process-id", str(rank)])
    except Killed:
        log.lines.append("killed")
    finally:
        port_checkpoint.save_propagator_state = save
    return log.lines


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _rank_main(rank, world, out_dir, jobs, cli_runs):
    torch.set_num_threads(1)
    out_dir = pathlib.Path(out_dir)
    results = {}
    if jobs:
        group = init_group(f"file://{out_dir / 'store'}", world, rank, "cpu",
                           timeout=RANK_TIMEOUT)
        try:
            for name, kwargs in jobs:
                for key, value in JOBS[name](group, **kwargs).items():
                    results[f"{name}/{key}"] = value
        finally:
            destroy_group(group)
    for i, (cfg, kill_after) in enumerate(cli_runs):
        lines = run_cli(rank, world, cfg, out_dir / f"cli_store{i}",
                        kill_after)
        results[f"cli{i}/log"] = np.asarray(json.dumps(lines))
    np.savez(out_dir / f"rank{rank}.npz", **results)


def spawn(world, out_dir, jobs=(), cli_runs=()):
    """Run `jobs` ((name, kwargs) pairs) and then the CLI runs `cli_runs`
    ((config path, kill_after) pairs) on `world` spawned ranks. Returns
    each rank's results as a dict; raises if a rank fails or hangs."""
    import torch.multiprocessing as mp

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(out_dir), list(jobs),
                               list(cli_runs)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise RuntimeError(f"ranks {hung} of {world} hung (no exit "
                               f"within {JOIN_TIMEOUT} s)")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks of {world} exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    out = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as data:
            out.append({k: data[k] for k in data.files})
    return out


def as_task_file(tmp, npz, ntraj=256, batch=128, steps=12, **keys):
    """A dynamics task on a 2-mode AS model file in `tmp` (HK, seed 11,
    error bars, checkpoints every 4 steps in scan segments of 4), written
    as a JSON document; returns its path."""
    tmp = pathlib.Path(tmp)
    model = tmp / "AS_model.dat"
    model.write_text("1500.0  0.1  0.5  0.02\n900.0  0.3  -0.4  0.02\n")
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS", "model_file": str(model)},
            "propagator": "HK", "batch_size": batch,
            "num_trajectories": ntraj, "num_steps": steps,
            "time_step_fs": 0.2, "manual_seed": 11, "error_bars": True,
            "scan_chunk": 4,
            "results": {"correlations": str(npz), "overwrite": True}}
    task.update(keys)
    cfg = tmp / f"{pathlib.Path(npz).stem}.json"
    cfg.write_text(json.dumps({"semi": [task]}))
    return cfg
