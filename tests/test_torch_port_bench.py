# coding: utf-8
"""The port's benchmark entry points, `bench_torch.py` and
`scripts/torch_pod_bench.py`, on the CPU at test-scale shapes.

* The AS60 model equals `__graft_entry__._as60_setup`'s (the JAX
  package's flagship) array for array.
* HK and WM on the AS60 model as `bench_torch.as60_setup` builds them,
  64 trajectories x 20 steps from the same injected normals in both
  packages: C(t) and k~ic(t) within 1e-8 of the JAX package's largest
  modulus at f64, within 2e-6 at comp32 (float32 algebra), the JAX
  package's same mode (PERF.md §2).
* The `gdml_coumarin` setup (taylor, taylor_every 32, float64
  trajectories), 8 trajectories x 40 steps across one window boundary
  (step 32), against the JAX package at a float64 Hessian (a float32
  Hessian is a noisy function of the geometry in both packages): at f64
  algebra within tests/test_torch_port_gdml.py's 1e-6 of the largest
  modulus; at the bench's mixed algebra within 1e-5 (each package's mixed
  run is ~3e-6 from its own f64 run; see the test).
* `python bench_torch.py --device cpu` at tiny BENCH_* sizes: three lines
  in the order wm, gdml, hk with bench.py's metric names and keys (no
  `vs_baseline`), exit 0, no JAX imported; without CUDA and without
  `--device cpu` it stops with a message; a bench that raises prints its
  error line and the script exits 1.
* The warm-up (`bench_torch.warm_up`) on a loop that captures (the CPU
  stand-in `ReplayGraph`, whose replays run the recorded bodies): each
  bench's scan then
  shows 0 captures and 0 eager blocks, and its curves equal the eager
  run's.
* `torch_pod_bench.run` on a gloo group of 2 (tests/torch_group_workers.py)
  at 32 trajectories a rank x 10 steps: its line says nchips 2 and ntraj
  64, and its curves are within 1e-12 of one process's at 64.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.pytree import replace as jax_replace

import torch_group_workers as workers
from test_torch_port_graph import ReplayGraph
from test_torch_port_precision import MODES, SAME_MODE_TOL, jax_propagator

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402
from __graft_entry__ import _as60_setup  # noqa: E402
from semiclassical_tpu_torch import ops  # noqa: E402
from semiclassical_tpu_torch.propagation import graph  # noqa: E402

F64_TOL = 1e-8
GDML_TOL = 1e-6
GDML_MIXED_TOL = 1e-5
GROUP_TOL = 1e-12
NTRAJ, NSTEPS = 64, 20
TINY = {"BENCH_NTRAJ": "32", "BENCH_NT": "6", "BENCH_WM_NTRAJ": "32",
        "BENCH_WM_NT": "6", "BENCH_GDML_NTRAJ": "4", "BENCH_GDML_NT": "3"}
# bench.py's top-level keys (`_result`) without vs_baseline, and the keys
# bench_torch adds
LINE_KEYS = {"metric", "value", "unit", "config", "phases", "device",
             "peak_gb", "launches", "launches_by_dtype", "loop", "graph"}
CONFIG_KEYS = {
    "wm": {"ntraj", "nt", "dim", "dtype", "micro_batch", "device", "wall_s"},
    "gdml": {"ntraj", "nt", "n_cartesian", "hessian_eval", "taylor_every",
             "micro_batch", "hess_dtype", "device", "wall_s", "fixtures"},
    "hk": {"ntraj", "nt", "dim", "dtype", "device", "wall_s", "warmup_s"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here on one intra-op thread: the suite's worker
    processes otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def test_as60_model_matches_graft_entry():
    """omega, chi (through the Morse a and D), nac and dQ equal the JAX
    flagship's, and the port's potential holds the same parameters."""
    prop_j, pot_j = _as60_setup(ntraj=8)
    omega, S, nac, chi, dQ = bench_torch.as60_model()
    np.testing.assert_array_equal(omega, np.asarray(pot_j.omega))
    np.testing.assert_array_equal(nac, np.asarray(pot_j.nac))
    np.testing.assert_array_equal(dQ, np.asarray(prop_j.sampling.z0)[:60])
    ref = jax_potentials.MorsePotential.create(omega, chi, nac)
    for name in ("a", "D"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      np.asarray(getattr(pot_j, name)))
    prop, pot = bench_torch.as60_setup(8, "cpu")
    for name in ("omega", "a", "D", "nac"):
        np.testing.assert_array_equal(getattr(pot, name).numpy(),
                                      np.asarray(getattr(pot_j, name)))
    np.testing.assert_allclose(omega * dQ ** 2 / 2, S, rtol=1e-14)


def _draw(n, rank, seed):
    return np.random.default_rng(seed).standard_normal((n, 2 * rank))


@pytest.mark.parametrize("mode", ["f64", "comp32"])
@pytest.mark.parametrize("name", ["HK", "WM"])
def test_as60_matches_jax(name, mode, monkeypatch):
    """The bench's AS60 propagators (HK: energy origin 0; WM: the zero-point
    energy, alpha = beta = 1e4) against the JAX package's from the same
    normals, 64 x 20 steps of 0.25 a.u."""
    dtype_j, _, dtype, traj = MODES[mode]
    omega, _, nac, chi, dQ = bench_torch.as60_model()
    G = np.diag(omega)
    draw = _draw(NTRAJ, 60, 5)
    en0 = 0.0 if name == "HK" else float(np.sum(0.5 * omega))
    cls_j, args = (JaxHK, ()) if name == "HK" else (JaxWM, (1e4, 1e4))
    pot_j = jax_potentials.MorsePotential.create(omega, chi, nac,
                                                 dtype=dtype_j)
    prop_j = jax_propagator(cls_j, G, dQ, pot_j, draw, mode, monkeypatch,
                            *args)
    cj, kj = prop_j.propagate(pot_j, bench_torch.AS60_DT, NSTEPS,
                              energy0_es=en0, check_energy=False)
    prop, pot = bench_torch.as60_setup(NTRAJ, "cpu", name, dtype, traj,
                                       normals=torch.from_numpy(draw))
    assert pot.omega.dtype == dtype
    c, k = prop.propagate(pot, bench_torch.AS60_DT, NSTEPS, energy0_es=en0,
                          check_energy=False)
    tol = F64_TOL if mode == "f64" else SAME_MODE_TOL
    assert _rel(c, cj) <= tol and _rel(k, kj) <= tol
    assert abs(c[0] - 1) < 1e-3


@pytest.fixture(scope="module")
def gdml_runs(ref_data):
    """bench_torch's coumarin setup at a float64 Hessian, 8 x 40 steps of
    0.1 a.u. (the taylor_every 32 window restarts at step 32, one scan
    segment in both packages), at f64 and mixed algebra, beside the JAX
    package's from the same normals: {(side, mode): (C, k~ic)}."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SEMI_REF_DATA", str(ref_data))
    with np.load(ref_data / bench_torch.GDML_MODEL, allow_pickle=True) as f:
        model = dict(f)
    with open(ref_data / bench_torch.GDML_FCHK) as f:
        exc_j = JaxFchk(f)
    x0, G0, _ = exc_j.vibrational_groundstate()
    x0 = np.asarray(x0)
    draw = _draw(8, 45, 17)
    pot_j = jax_potentials.MolecularGDMLPotential.create(
        model, exc_j, hessian_eval="taylor")
    pot_j = jax_potentials.minimize(jax_replace(pot_j, taylor_every=32),
                                    jnp.asarray(x0))
    out = {}
    try:
        for mode in ("f64", "mixed"):
            prop, pot, x0_p, _, _ = bench_torch.gdml_setup(
                8, "cpu", normals=torch.from_numpy(draw), hess_dtype=None,
                dtype=MODES[mode][2])
            np.testing.assert_array_equal(x0_p, x0)
            assert pot.taylor_every == 32 and pot.hessian_eval == "taylor"
            assert prop.traj_dtype == torch.float64
            out["port", mode] = prop.propagate(
                pot, bench_torch.GDML_DT, 40, energy0_es=0.0,
                check_energy=False)
            prop_j = jax_propagator(JaxHK, G0, x0, pot_j, draw, mode, mp,
                                    diag=False)
            out["jax", mode] = prop_j.propagate(
                pot_j, bench_torch.GDML_DT, 40, energy0_es=0.0,
                check_energy=False)
    finally:
        mp.undo()
    return out


def test_gdml_setup_matches_jax_f64(gdml_runs):
    """At f64 algebra: tests/test_torch_port_gdml.py's 1e-6."""
    for got, ref in zip(gdml_runs["port", "f64"], gdml_runs["jax", "f64"]):
        assert _rel(got, ref) <= GDML_TOL


def test_gdml_setup_mixed_matches_jax_mixed(gdml_runs):
    """At the bench's mixed algebra (float32 monodromy and observables)
    each package's run sits ~3e-6 from its own f64 run (measured: 2.7e-6
    and 3.0e-6 in C(t), 3.2e-6 in both k~ic(t)), so the two mixed runs
    are held at GDML_MIXED_TOL = 1e-5 of each other, and each against its
    f64 run at the mixed mode's gates (PERF.md §2: 1e-4 / 1e-3)."""
    for got, ref in zip(gdml_runs["port", "mixed"], gdml_runs["jax", "mixed"]):
        assert _rel(got, ref) <= GDML_MIXED_TOL
    for side in ("port", "jax"):
        (c, k), (c64, k64) = gdml_runs[side, "mixed"], gdml_runs[side, "f64"]
        assert _rel(c, c64) <= 1e-4 and _rel(k, k64) <= 1e-3
        assert abs(c[0] - 1) < 1e-3


def test_gdml_fixture_missing_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(bench_torch, "REPO", str(tmp_path))
    monkeypatch.setenv("SEMI_REF_DATA", str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="no sGDML fixture"):
        bench_torch.gdml_fixture_dir()


_RUN_MAIN = """
import runpy, sys
sys.argv = ["bench_torch.py"] + sys.argv[1:]
try:
    runpy.run_path("bench_torch.py", run_name="__main__")
finally:
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    print("JAX_MODULES", bad)
"""


def _bench(args, **env):
    full = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
                **env)
    full["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [full.get("PYTHONPATH")] if p])
    return subprocess.run([sys.executable, "-c", _RUN_MAIN, *args],
                          cwd=REPO, env=full, capture_output=True, text=True,
                          timeout=300)


def test_bench_cli_on_the_cpu():
    """Three lines in the print order, bench.py's metric names and keys,
    exit 0, and no JAX module imported by the run."""
    out = _bench(["--device", "cpu"], **TINY)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "JAX_MODULES []"
    lines = [json.loads(x) for x in lines[:-1]]
    assert [x["metric"] for x in lines] == [
        f"{n}_traj_steps_per_sec_per_chip" for n in ("wm_as60",
                                                     "gdml_coumarin",
                                                     "hk_as60")]
    for name, line in zip(("wm", "gdml", "hk"), lines):
        assert set(line) == LINE_KEYS, name
        assert set(line["config"]) == CONFIG_KEYS[name], name
        assert set(line["phases"]) == {"sample", "warmup", "scan", "reduce"}
        assert line["unit"] == "traj-steps/s/chip" and line["value"] > 0
        assert line["device"] == "cpu" and line["peak_gb"] is None
        assert line["launches"] == dict.fromkeys(ops.launch_counts(), 0)
        # the CPU runs the loop's blocks eagerly: no capture, no replay
        assert line["loop"] == "eager" and line["graph"]["eager_blocks"] > 0
        assert line["graph"]["captures"] == line["graph"]["replays"] == 0
        key = {"wm": "BENCH_WM_", "gdml": "BENCH_GDML_", "hk": "BENCH_"}[name]
        assert line["config"]["ntraj"] == int(TINY[key + "NTRAJ"])
        assert line["config"]["nt"] == int(TINY[key + "NT"])
    assert lines[0]["config"]["dtype"] == lines[2]["config"]["dtype"] \
        == "float64"


def test_bench_needs_cuda_unless_asked_for_the_cpu():
    out = _bench([], **TINY)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "--device cpu" in out.stderr
    assert "_traj_steps_per_sec_per_chip" not in out.stdout


def test_failed_bench_prints_its_error_and_exits_nonzero():
    out = _bench(["--device", "cpu"], BENCH_ONLY="hk", BENCH_DTYPE="bogus",
                 **TINY)
    assert out.returncode == 1
    line = json.loads(out.stdout.strip().splitlines()[0])
    assert line["metric"] == "hk_bench_error"
    assert "bogus" in line["error"]


def test_run_benches_keeps_going_after_a_failure(monkeypatch):
    """A bench that raises leaves its error line; the others still run."""
    monkeypatch.setenv("BENCH_DTYPE", "bogus")
    for key, value in TINY.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(bench_torch, "BENCHES",
                        dict(bench_torch.BENCHES, gdml=None))
    results = bench_torch.run_benches("cpu", only="")
    assert results["hk"]["metric"] == "hk_bench_error"
    assert results["gdml"]["metric"] == "gdml_bench_error"
    assert isinstance(results["wm"], bench_torch.BenchResult)
    assert results["wm"].prop is None


def test_warm_up_leaves_the_scan_only_replays(monkeypatch):
    """Blocks of 4 steps: hk 6 steps (4 and a tail of 2, each once), wm 6
    steps in two sub-batches, gdml 3 steps under taylor_every 32 (one
    block of 3). After the warm-up and the redraw, each scan replays every
    block: 0 captures, 0 eager blocks; the curves equal the eager run's."""
    for key, value in dict(TINY, BENCH_WM_MICRO="16").items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(graph, "BLOCK_STEPS", 4)
    eager = {name: bench_torch.BENCHES[name]("cpu").curves
             for name in bench_torch.EXEC_ORDER}
    monkeypatch.setattr(graph, "SegmentGraph", ReplayGraph)
    graph.clear()
    try:
        for name in bench_torch.EXEC_ORDER:
            result = bench_torch.BENCHES[name]("cpu")
            counts = result.line["graph"]
            assert counts["captures"] == counts["eager_blocks"] == 0, name
            assert counts["replays"] > 0, name
            for got, ref in zip(result.curves, eager[name], strict=True):
                assert np.array_equal(got, ref), name
            graph.clear()
    finally:
        graph.clear()


def test_pod_bench_group_of_two_equals_one_process(tmp_path):
    ranks = workers.spawn(2, tmp_path,
                          jobs=[("pod_bench", {"ntraj_per_chip": 32,
                                               "nt": 10})])
    ref = workers.job_pod_bench(None, ntraj_per_chip=64, nt=10)
    assert int(ref["nchips"]) == 1 and int(ref["ntraj"]) == 64
    for r in ranks:
        line = json.loads(str(r["pod_bench/line"]))
        assert line["nchips"] == 2 and line["ntraj"] == 64
        assert line["traj_steps_per_s_per_chip"] > 0
        for key in ("c", "k"):
            assert _rel(r[f"pod_bench/{key}"], ref[key]) <= GROUP_TOL, key
