# coding: utf-8
"""The port's process group (semiclassical_tpu_torch.parallel) on gloo at
worlds 2 and 4: the twins of the JAX package's mesh tests.

Ranks are spawned processes (tests/torch_group_workers.py), one intra-op
thread each, on a `file://` store; every rank draws the whole batch and
propagates its shard, so the group's results are held against the
single-process port at the same seed and the (rounded-up) batch size:

* C(t) and k~ic(t) within 1e-12 of their largest modulus (f64: HK and
  WM, dense and separable, RK4 and exact with routed rows on every shard,
  antithetic sampling with error bars and micro_batch). The error bars
  are held through the second moment they are computed from, sum |x|^2 =
  n stderr^2 + |sum x|^2 / n, at 1e-12 of its largest value: the stderr
  is the square root of a difference that cancels (antithetic pairs at
  the first steps, t = 0 everywhere), so the new order of the sums moves
  it by up to ~1e-11 of its largest value after t = 0, under the JAX
  twin's atol of 1e-9, and at t = 0 by its whole rounding-noise value. Under comp32
  the shard's q, qc, p and S are bit-identical to the single process's
  rows, and the complex64 batch sums within the JAX twin's 2e-6 of their
  largest modulus (float32 sums in another order);
* the ring pair sum within 1e-12 (relative) of the JAX package's
  `_pair_sum_ring` on a 2- and a 4-device sub-mesh of the conftest's 8 CPU
  devices at the same arrays and block, and of the single-process
  ordered grid; the propagators' norms within 1e-12 of the single
  process's;
* a per-rank checkpoint resumed bit for bit, and a resume under another
  group size refused naming 'meta/world';
* the CLI on two ranks (`--coordinator file://...`): the npz of rank 0
  against the single-process CLI, a run killed after its second
  checkpoint write resumed to within 1e-10 of the uninterrupted one, the
  progress and norm lines on rank 0 only.
"""

import json

import numpy as np
import pytest
import torch

import jax

from semiclassical_tpu.coherent import OverlapParams as JaxOverlapParams
from semiclassical_tpu.parallel import ensemble_mesh
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu_torch import checkpoint as port_checkpoint
from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch.config import ConfigurationError
from semiclassical_tpu_torch.parallel import (Group, group_sum, init_group,
                                              pad_to_multiple, rank_path,
                                              shard_rows)
from semiclassical_tpu_torch.propagation import hk
from semiclassical_tpu_torch.propagation import HermanKlukPropagator

import torch_group_workers as workers

WORLDS = (2, 4)
GATE = 1e-12
RING_BLOCK = 8
RING_N = 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jobs(path):
    return [("hk_1d", {}), ("wm_1d", {}), ("rank_deficient", {}),
            ("multimode", {}), ("sobol", {}), ("wm_separable", {}),
            ("comp32", {}),
            ("exact", {}), ("ring", {"n": RING_N, "block": RING_BLOCK}),
            ("norms", {}), ("checkpoint", {"path": str(path)})]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank results]}: one spawn per world running every job; the
    world-4 ranks also try to resume the world-2 checkpoints."""
    out, dirs = {}, {}
    for world in WORLDS:
        d = dirs[world] = tmp_path_factory.mktemp(f"world{world}")
        jobs = _jobs(d / "ck.npz")
        if world == 4:
            jobs.append(("checkpoint_other_world",
                         {"path": str(dirs[2] / "ck.npz")}))
        out[world] = workers.spawn(world, d, jobs)
    out["dirs"] = dirs
    return out


_SINGLE = {}


def single(name, **kwargs):
    """The job on a single process (cached per arguments)."""
    key = (name, json.dumps(kwargs, sort_keys=True))
    if key not in _SINGLE:
        _SINGLE[key] = workers.JOBS[name](None, **kwargs)
    return _SINGLE[key]


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _curves(res, job, ref, keys=("c", "k")):
    for key in keys:
        assert _rel(res[f"{job}/{key}"], ref[key]) < GATE, key


def _error_bars(res, job, ref, pairs=False):
    """stderr held through sum |x|^2 = n stderr^2 + |sum x|^2 / n at every
    step, and directly at the JAX twin's tolerance after the first step:
    at t = 0 the true variance of C is zero, so its stderr is the square
    root of the sums' rounding (1e-9 under Sobol' draws, or 0 where the
    clamp takes a negative difference) in either order."""
    n = int(ref["ntraj"]) // (2 if pairs else 1)
    for e, c in (("ec", "c"), ("ek", "k")):
        m2 = lambda r: n * r[e] ** 2 + np.abs(r[c]) ** 2 / n
        got = {e: res[f"{job}/{e}"], c: res[f"{job}/{c}"]}
        assert _rel(m2(got), m2(ref)) < GATE, e
        np.testing.assert_allclose(got[e][1:], ref[e][1:], rtol=1e-10,
                                   atol=1e-9)


def _agree(res_list, job):
    """Every rank returns the batch's results, bit for bit."""
    for res in res_list[1:]:
        for key in ("c", "k", "ec", "ek"):
            name = f"{job}/{key}"
            if name in res:
                assert np.array_equal(res[name], res_list[0][name]), name


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", ["hk_1d", "wm_1d"])
def test_non_divisible_ntraj_rounds_up_with_true_weights(ranks, world, job):
    """1001 trajectories round up to a multiple of the group's size with
    real extra samples; the group equals the single process at that
    count, error bars included, and C(0) stays normalised."""
    res = ranks[world][0]
    ntraj = int(res[f"{job}/ntraj"])
    assert ntraj == pad_to_multiple(1001, world) and ntraj > 1001
    ref = single(job, ntraj=ntraj)
    _curves(res, job, ref)
    _error_bars(res, job, ref)
    assert abs(res[f"{job}/c"][0] - 1.0) < 5e-2
    _agree(ranks[world], job)


@pytest.mark.parametrize("world", WORLDS)
def test_group_rank_deficient(ranks, world):
    """Singular widths (4 modes + 2 zero modes, the dense path), HK and WM."""
    res, ref = ranks[world][0], single("rank_deficient")
    _curves(res, "rank_deficient", ref, ("hk_c", "hk_k", "wm_c", "wm_k"))
    assert abs(res["rank_deficient/hk_c"][0] - 1.0) < 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_group_multimode_antithetic(ranks, world):
    """5-mode separable HK, antithetic pairs kept within shards, error
    bars over pairs, micro_batch 32 splitting each shard."""
    res, ref = ranks[world][0], single("multimode")
    _curves(res, "multimode", ref)
    _error_bars(res, "multimode", ref, pairs=True)
    _agree(ranks[world], "multimode")


@pytest.mark.parametrize("world", WORLDS)
def test_group_sobol(ranks, world):
    """Sobol' draws: every rank takes its rows of the one scrambled
    sequence."""
    res, ref = ranks[world][0], single("sobol")
    _curves(res, "sobol", ref)
    _error_bars(res, "sobol", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_group_wm_separable(ranks, world):
    res, ref = ranks[world][0], single("wm_separable")
    _curves(res, "wm_separable", ref)
    _error_bars(res, "wm_separable", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_group_comp32(ranks, world):
    """comp32: every shard's trajectories are the single process's rows
    bit for bit; the complex64 batch sums re-associate."""
    ref = single("comp32")
    for res in ranks[world]:
        a, b = res["comp32/rows"]
        for key in ("q", "qc", "p", "S"):
            assert np.array_equal(res[f"comp32/{key}"], ref[key][a:b]), key
    res = ranks[world][0]
    for key in ("c", "k"):
        np.testing.assert_allclose(res[f"comp32/{key}"], ref[key], rtol=0,
                                   atol=2e-6 * np.abs(ref[key]).max())


@pytest.mark.parametrize("world", WORLDS)
def test_group_exact_routed_rows(ranks, world):
    """The exact Morse map with routed rows on every shard: the routed
    count is taken over the group, the side-channel stays per shard."""
    res, ref = ranks[world][0], single("exact")
    routed = [int(r["exact/routed_here"]) for r in ranks[world]]
    assert all(routed) and sum(routed) == int(ref["routed_here"])
    _curves(res, "exact", ref)
    _error_bars(res, "exact", ref)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_matches_jax_ring(ranks, world):
    """The port's ring pair sum against the JAX package's shard_map ring
    on a sub-mesh of `world` CPU devices, on the same arrays and block,
    and against the single-process ordered grid."""
    G, q, p, lr, li = workers.ring_arrays(RING_N)
    mesh = ensemble_mesh(jax.devices()[:world])
    ref = jax_hk._pair_sum_ring(jax_hk._hk_norm_log_block_term,
                                JaxOverlapParams.create(G, G),
                                (q, p, lr, li), mesh, RING_BLOCK)
    got = float(ranks[world][0]["ring/norm2"])
    assert abs(got - ref) < GATE * abs(ref)
    grid = float(single("ring", n=RING_N, block=RING_BLOCK)["norm2"])
    assert abs(got - grid) < GATE * abs(grid)
    assert all(float(r["ring/norm2"]) == got for r in ranks[world])


@pytest.mark.parametrize("world", WORLDS)
def test_norm_through_the_ring(ranks, world):
    """test_norm_device.py's ring tests: the HK log norm, the linear norm
    in blocks of 32 inside a shard and the WM norm equal the single
    process's; at rank-deficient widths the HK ring equals the ordered
    grid; the subsampled norm is refused under a group."""
    res, ref = ranks[world][0], single("norms")
    for key in ("hk_log", "hk_linear", "wm", "hk_deficient"):
        got, want = float(res[f"norms/{key}"]), float(ref[key])
        assert np.isfinite(got) and abs(got - want) < GATE * abs(want), key
    assert bool(res["norms/sampled_raises"])


@pytest.mark.parametrize("world", WORLDS)
def test_granular_accessors_sum_the_batch(ranks, world):
    """autocorrelation, ic_correlation and wavefunction under a group are
    the whole batch's (HK and WM)."""
    res, ref = ranks[world][0], single("norms")
    for key in ("auto", "kic", "psi", "wm_auto", "wm_kic", "wm_psi"):
        assert _rel(res[f"norms/{key}"], ref[key]) < GATE, key


@pytest.mark.parametrize("world", WORLDS)
def test_restore_per_rank_checkpoint(ranks, world):
    """Each rank saves its rows into its own file and restores them into
    a fresh batch of another seed: the 13 resumed steps equal the last 13
    of the uninterrupted run, and the group's equal the single
    process's."""
    res, ref = ranks[world][0], single("checkpoint", path=str(
        ranks["dirs"][world] / "single.npz"))
    for key in ("c", "k"):
        np.testing.assert_allclose(res[f"checkpoint/{key}"],
                                   res[f"checkpoint/whole_{key}"][12:],
                                   rtol=1e-12, atol=1e-14)
    _curves(res, "checkpoint", ref, ("c", "k", "whole_c", "whole_k"))
    for r in range(world):
        with np.load(rank_path(str(ranks["dirs"][world] / "ck.npz"),
                               r)) as data:
            assert int(data["meta/rank"]) == r
            assert int(data["meta/world"]) == world


def test_resume_under_another_world_raises(ranks):
    """Checkpoints of a 2-rank group: a 4-rank group refuses them on every
    rank, and a single process refuses a rank's file, naming the key."""
    for res in ranks[4]:
        assert "'meta/world'" in str(res["checkpoint_other_world/message"])
    prop = HermanKlukPropagator(np.array([[5.0]]), np.array([[5.0]]),
                                device="cpu")
    from semiclassical_tpu_torch.potentials import NonHarmonicPotential
    prop.initial_conditions(np.array([7.3]), np.array([0.0]),
                            np.array([[1.0]]),
                            NonHarmonicPotential.create(device="cpu"),
                            ntraj=256, generator=torch.Generator())
    fname = rank_path(str(ranks["dirs"][2] / "ck.npz"), 0)
    with pytest.raises(ValueError, match="'meta/world'"):
        port_checkpoint.load_propagator_state(fname, prop)


def test_ring_block_count_selection():
    """The twin of test_norm_device.py's: never one whole-shard block for
    a shard larger than the block; a divisor near the block, or a
    refusal."""
    assert hk._ring_block_count(8192, 4096) == 2
    assert hk._ring_block_count(4096, 4096) == 1
    assert hk._ring_block_count(1000, 4096) == 1
    assert hk._ring_block_count(6144, 4096) == 2
    assert hk._ring_block_count(40960, 4096) == 10
    assert hk._ring_block_count(5000, 4096) == 2
    with pytest.raises(ValueError, match="divide"):
        hk._ring_block_count(4097, 4096)
    from semiclassical_tpu.propagation.hk import _ring_block_count
    for n_loc, block in ((8192, 4096), (6144, 4096), (5000, 4096),
                         (48, 8), (625, 655), (10000, 655)):
        assert hk._ring_block_count(n_loc, block) == _ring_block_count(
            n_loc, block)


def test_shards_and_single_process_helpers():
    """shard_rows tiles the batch; a single process's group_sum and
    rank_path are the identity."""
    groups = [Group(r, 4, torch.device("cpu")) for r in range(4)]
    assert [shard_rows(1004, g) for g in groups] == [
        (0, 251), (251, 502), (502, 753), (753, 1004)]
    assert shard_rows(1001, None) == (0, 1001)
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(1001, groups[0])
    assert pad_to_multiple(1001, 4) == 1004 and pad_to_multiple(8, 4) == 8
    x = torch.tensor([1.0 + 2.0j])
    assert group_sum([x], None)[0] is x
    assert rank_path("ck.npz", None) == "ck.npz"
    assert rank_path("run/ck.npz", 3) == "run/ck.rank3.npz"
    assert rank_path("", 1) == ""


def test_cuda_group_without_card_raises(monkeypatch):
    """A group asked for on 'cuda' where there is no card raises before
    any rendezvous: no move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_group("127.0.0.1:1", 2, 0, "cuda")
    with pytest.raises(ValueError, match="process-id"):
        init_group("127.0.0.1:1", 2, 2, "cpu")


def test_devices_and_norm_samples_refused(tmp_path):
    """--devices 2 is refused by name (one process per device), and the
    subsampled norm under a group is refused up front."""
    cfg = workers.as_task_file(tmp_path, tmp_path / "c.npz")
    with pytest.raises(ConfigurationError, match="--devices 2"):
        cli.main(["dynamics", str(cfg), "--device", "cpu", "--devices", "2"])
    task = json.loads(cfg.read_text())["semi"][0]
    task["norm_samples"] = 64
    cli.check_slice(task, "f64")
    with pytest.raises(ConfigurationError, match="norm_samples"):
        cli.check_slice(task, "f64", Group(0, 2, torch.device("cpu")))


# ---------------------------------------------------------------------------
# the CLI on two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_group(tmp_path_factory):
    """Two ranks through `cli.main --coordinator file://...`: an
    uninterrupted run (checkpoints, norms every 6 steps, two batches),
    then the same task killed after its second checkpoint write and run
    again; and the single-process CLI at the same seed."""
    d = tmp_path_factory.mktemp("cli")
    keys = dict(checkpoint_every=4, calc_norm_every=6)
    cfg_a = workers.as_task_file(d, d / "a.npz", checkpoint=str(d / "ck_a"
                                                                ".npz"),
                                 **keys)
    cfg_b = workers.as_task_file(d, d / "b.npz", checkpoint=str(d / "ck_b"
                                                                ".npz"),
                                 **keys)
    res = workers.spawn(2, d, cli_runs=[(cfg_a, None), (cfg_b, 2),
                                        (cfg_b, None)])
    cfg_s = workers.as_task_file(d, d / "s.npz", **keys)
    task = json.loads(cfg_s.read_text())["semi"][0]
    single_log = workers.LogLines()
    with single_log:
        cli.run_semiclassical_dynamics(task, device="cpu")
    logs = [[json.loads(str(r[f"cli{i}/log"])) for i in range(3)]
            for r in res]
    return dict(d=d, logs=logs, single_log=single_log.lines,
                **{name: dict(np.load(d / f"{name}.npz"))
                   for name in ("a", "b", "s")})


def test_cli_group_matches_single_process(cli_group):
    a, s = cli_group["a"], cli_group["s"]
    assert int(a["trajectories"]) == int(s["trajectories"]) == 256
    for key in ("autocorrelation", "ic_correlation"):
        assert _rel(a[key], s[key]) < GATE, key
    n = 128   # the batch size: the npz holds the batches' mean
    for e, c in (("autocorrelation_stderr", "autocorrelation"),
                 ("ic_correlation_stderr", "ic_correlation")):
        m2 = lambda r: n * r[e] ** 2 + np.abs(r[c]) ** 2 / n
        assert _rel(m2(a), m2(s)) < GATE, e


def test_cli_group_killed_run_resumes(cli_group):
    """The killed run's ranks stopped after their second checkpoint
    write; the rerun resumed from the per-rank files and lands within
    1e-10 of the uninterrupted run; every checkpoint is gone."""
    assert all(logs[1][-1] == "killed" for logs in cli_group["logs"])
    assert any("found checkpoint" in line
               for line in cli_group["logs"][0][2])
    a, b = cli_group["a"], cli_group["b"]
    for key in ("autocorrelation", "ic_correlation",
                "autocorrelation_stderr", "ic_correlation_stderr"):
        np.testing.assert_allclose(b[key], a[key], rtol=0,
                                   atol=1e-10 * np.abs(a[key]).max())
    assert not list(cli_group["d"].glob("ck_*"))


def test_cli_group_logs_on_rank_zero(cli_group):
    """Progress and norm lines on rank 0 only; the norms equal the single
    process's to the printed digits."""
    rank0, rank1 = (logs[0] for logs in cli_group["logs"])
    norms = [line for line in rank0 if "norm=" in line]
    assert norms and any("|C(t)|=" in line for line in rank0)
    assert norms == [line for line in cli_group["single_log"]
                     if "norm=" in line]
    assert not any("norm=" in line or "|C(t)|=" in line for line in rank1)
    assert "process group: rank 0 of 2" in " ".join(rank0)
    assert any("per device, 2 devices" in line for line in rank0)
