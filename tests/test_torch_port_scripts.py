# coding: utf-8
"""The port's validation scripts (scripts/torch_validate_1d.py,
scripts/torch_sgdml_compare_normal_modes.py,
scripts/torch_sgdml_compare_relaxed_scan.py) against the JAX package's
twins, run through their `main` on the CPU.

* The sGDML comparisons on the coumarin fixtures of tests/test_scripts.py:
  the same exit codes and table layout; the sGDML frequencies (captured at
  `vibrational_frequencies`) within 1e-6 relative for the internal modes;
  the six rigid-body ones as the signed squares (the Hessian's eigenvalues,
  which vanish up to the minimisation's residual) within 1e-6 of the
  largest; the sGDML energies
  (captured at `gdml_forward`) within 1e-7 Ha, the floor of two float64
  sGDML implementations (the KRR sums cancel 1e5-1e7x).
* torch_validate_1d at 2000 trajectories x 40 steps over half a period
  passes its own gates, writes its figures, and stops with exit code 2 and
  a message when `--plot` is asked for without matplotlib.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gdml_fixtures(ref_data):
    model = (ref_data / "GDML"
             / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    fchk = ref_data / "Gaussian16" / "coumarin_s0.fchk"
    xyz = ref_data / "GDML" / "coumarin.xyz"
    if not (model.exists() and fchk.exists() and xyz.exists()):
        pytest.skip("coumarin fixtures not available")
    return model, fchk, xyz


def _capture(monkeypatch, mod, name, calls):
    """Wrap `mod.name`, appending each call's result to `calls`."""
    fn = getattr(mod, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(mod, name, wrapped)


def _rows(path):
    return [ln.split() for ln in path.read_text().splitlines()
            if ln and not ln.startswith("#")]


def test_normal_modes_matches_jax_script(gdml_fixtures, tmp_path,
                                         monkeypatch):
    model, fchk, _ = gdml_fixtures
    out = {}
    for side, name in (("port", "torch_sgdml_compare_normal_modes"),
                       ("jax", "sgdml_compare_normal_modes")):
        mod = _load(name)
        calls = []
        _capture(monkeypatch, mod, "vibrational_frequencies", calls)
        path = tmp_path / f"{side}.dat"
        argv = ["prog", str(model), str(fchk), str(path)]
        assert mod.main(argv + (["--device", "cpu"] if side == "port"
                                else [])) == 0
        out[side] = (calls[1][0], _rows(path))
    (f_port, rows), (f_jax, rows_j) = out["port"], out["jax"]
    assert len(rows) == len(rows_j) == 51
    assert [r[0] for r in rows] == [r[0] for r in rows_j]
    assert [r[1] for r in rows] == [r[1] for r in rows_j]   # the QM column
    w2, w2_jax = np.sign(f_port) * f_port**2, np.sign(f_jax) * f_jax**2
    assert np.abs(w2[:6] - w2_jax[:6]).max() <= 1e-6 * np.abs(w2_jax).max()
    assert (np.abs(f_port[6:] - f_jax[6:]) <= 1e-6 * np.abs(f_jax[6:])).all()


def test_relaxed_scan_matches_jax_script(gdml_fixtures, tmp_path,
                                         monkeypatch):
    model, _, xyz = gdml_fixtures
    out = {}
    for side, name in (("port", "torch_sgdml_compare_relaxed_scan"),
                       ("jax", "sgdml_compare_relaxed_scan")):
        mod = _load(name)
        calls = []
        _capture(monkeypatch, mod, "gdml_forward", calls)
        path = tmp_path / f"{side}.dat"
        argv = ["prog", str(model), str(xyz), str(path)]
        assert mod.main(argv + (["--device", "cpu"] if side == "port"
                                else [])) == 0
        energies = calls[0]
        out[side] = (np.asarray(energies.cpu() if torch.is_tensor(energies)
                                else energies), _rows(path))
    (e_port, rows), (e_jax, rows_j) = out["port"], out["jax"]
    assert e_port.shape == e_jax.shape == (1,)
    assert np.abs(e_port - e_jax).max() <= 1e-7
    assert len(rows) == len(rows_j) == 1
    assert rows[0][:2] == rows_j[0][:2]
    assert np.isfinite(float(rows[0][2]))


@pytest.mark.parametrize("name", ["torch_sgdml_compare_normal_modes",
                                  "torch_sgdml_compare_relaxed_scan"])
def test_sgdml_scripts_usage_exit(name, capsys):
    assert _load(name).main(["prog", "--device", "cpu"]) == 1
    assert "Usage:" in capsys.readouterr().out


def test_validate_1d_passes_its_gates(tmp_path, capsys):
    mod = _load("torch_validate_1d")
    out = tmp_path / "figs"
    rc = mod.main(["prog", "--ntraj", "2000", "--periods", "0.5", "--nt",
                   "40", "--device", "cpu", "--plot", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert text.count("=> PASS") == 2
    assert (out / "correlations_1d.png").exists()
    assert (out / "wavefunctions_1d.png").exists()


def test_validate_1d_plot_needs_matplotlib(tmp_path, monkeypatch, capsys):
    mod = _load("torch_validate_1d")
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(mod.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib"
                        else find_spec(name, *a))
    rc = mod.main(["prog", "--device", "cpu", "--plot", str(tmp_path)])
    assert rc == 2
    assert "--plot needs matplotlib" in capsys.readouterr().err
