# coding: utf-8
"""The port's host layer against the JAX package, on the vendored
methylium fixtures: fchk parsing, the vibrational ground state, the
harmonic potential and its minimiser, the npz results protocol in both
directions, the rate FFT — and a guard that the port imports no jax.

Tolerances: parsing is exact; the numpy-side derivations run the same
float64 operations in both packages (1e-12); the minimiser's energy origin,
which every later phase depends on, to 1e-10.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu.io import results as jax_results
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch.io import results
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                minimize)

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "semiclassical_tpu_torch"


@pytest.fixture(scope="module")
def methylium(ref_data):
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")
    return base


def _read(cls, path):
    with open(path) as f:
        return cls(f)


@pytest.mark.parametrize("name", ["opt_freq_s0.fchk", "opt_freq_s1.fchk"])
def test_fchk_fields_equal(methylium, name):
    mine = _read(FormattedCheckpointFile, methylium / name)
    ref = _read(JaxFchk, methylium / name)
    assert list(mine.keys()) == list(ref.keys())
    for key in ref.keys():
        np.testing.assert_array_equal(np.asarray(mine[key]),
                                      np.asarray(ref[key]), err_msg=key)
    for a, b in zip(mine.harmonic_approximation(),
                    ref.harmonic_approximation()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.masses(), ref.masses())


def test_vibrational_groundstate(methylium):
    x0, G0, zpe = _read(FormattedCheckpointFile,
                        methylium / "opt_freq_s1.fchk").vibrational_groundstate()
    x0_j, G0_j, zpe_j = _read(
        JaxFchk, methylium / "opt_freq_s1.fchk").vibrational_groundstate()
    np.testing.assert_allclose(x0, x0_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(G0, G0_j, rtol=0, atol=1e-12)
    assert abs(zpe - zpe_j) < 1e-12


def _potentials(methylium):
    s0, s1 = methylium / "opt_freq_s0.fchk", methylium / "opt_freq_s1.fchk"
    mine = MolecularHarmonicPotential.from_fchk(
        _read(FormattedCheckpointFile, s0), _read(FormattedCheckpointFile, s1),
        device="cpu")
    ref = jax_potentials.MolecularHarmonicPotential.from_fchk(
        _read(JaxFchk, s0), _read(JaxFchk, s1))
    return mine, ref


def test_from_fchk_and_expansion(methylium):
    mine, ref = _potentials(methylium)
    for name in ("pos0", "grad0", "hess0", "nac0", "mass"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert mine.energy0 == float(ref.energy0)
    q = np.asarray(ref.pos0)[None] + 0.05 * np.random.default_rng(1).standard_normal((5, 12))
    v, g, _ = mine.local_expansion(torch.from_numpy(q))
    v_j, g_j, _ = ref.local_expansion(jnp.asarray(q))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=0, atol=1e-12)


def test_minimize_origin(methylium):
    mine, ref = _potentials(methylium)
    x0, _, _ = _read(FormattedCheckpointFile,
                     methylium / "opt_freq_s1.fchk").vibrational_groundstate()
    origin = minimize(mine, x0).origin
    origin_j = float(jax_potentials.minimize(ref, jnp.asarray(x0)).origin)
    assert abs(origin - origin_j) < 1e-10


def _write_results(module, path, rng):
    times = np.linspace(0.0, 10.0, 7)
    module.init_results(str(path), "HK", times, 0.25, 0.01)
    for ntraj in (3, 5):
        cauto = np.exp(-1j * times) + 1e-4 * rng.standard_normal(7)
        cauto[0] = 1.0
        kic = 1e-6 * (rng.standard_normal(7) + 1j * rng.standard_normal(7))
        module.accumulate_results(str(path), cauto, kic, ntraj)
    return path


@pytest.mark.parametrize("writer, reader", [(results, jax_results),
                                            (jax_results, results)],
                         ids=["port-to-jax", "jax-to-port"])
def test_results_npz_round_trip(tmp_path, writer, reader):
    a = _write_results(writer, tmp_path / "a.npz", np.random.default_rng(5))
    b = _write_results(reader, tmp_path / "b.npz", np.random.default_rng(5))
    got, ref = reader.load_results(str(a)), reader.load_results(str(b))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_rates_equal(tmp_path):
    for name in ("port", "jax"):
        _write_results(results, tmp_path / f"{name}.npz",
                       np.random.default_rng(8))
    task = {"task": "rates", "broadening": "voigtian", "hwhmG_ev": 0.02}
    cli.calculate_rates(dict(task, correlations=str(tmp_path / "port.npz"),
                             rates=str(tmp_path / "port.npz")))
    jax_cli.calculate_rates(dict(task, correlations=str(tmp_path / "jax.npz"),
                                 rates=str(tmp_path / "jax.npz")))
    got, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_allclose(got["energies"], ref["energies"], rtol=1e-12)
    np.testing.assert_allclose(got["ic_rate"], ref["ic_rate"], rtol=1e-12,
                               atol=1e-12 * np.abs(ref["ic_rate"]).max())


_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import semiclassical_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
import bench_torch
for name in ("torch_pod_bench", "torch_vr_flagship_bench"):
    spec = importlib.util.spec_from_file_location(name, f"scripts/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "semiclassical_tpu" or k.startswith("semiclassical_tpu.")
             or k in ("bench", "__graft_entry__"))
assert not bad, bad
print("ok")
"""
# the port's entry points outside the package
ENTRY_POINTS = (REPO / "bench_torch.py",
                REPO / "scripts" / "torch_pod_bench.py",
                REPO / "scripts" / "torch_vr_flagship_bench.py")


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    forbidden = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+semiclassical_tpu\b"
        r"(?!_torch)|from\s+semiclassical_tpu\b(?!_torch))", re.M)
    files = sorted(PACKAGE.rglob("*.py"))
    assert files
    for path in files:
        assert not forbidden.search(path.read_text()), path
    # the entry points also import nothing of bench.py or __graft_entry__
    outside = re.compile(r"^\s*(import|from)\s+(bench|__graft_entry__)\b",
                         re.M)
    for path in ENTRY_POINTS:
        text = path.read_text()
        assert not forbidden.search(text), path
        assert not outside.search(text), path
