# coding: utf-8
"""The port's `export`, `show` and `plot` subcommands, its extended-XYZ
writer, `export_initial` / `export_final` and the NaN watchdog's trajectory
dump, on the CPU, held against the JAX package's CLI: the .dat tables byte
for byte, `show`'s text character for character, the extxyz text equal.
`plot` needs matplotlib (this sandbox has it; the machine with the card
does not).
"""

import filecmp
import os

import numpy as np
import pytest

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu.io.extxyz import write_extxyz as jax_write_extxyz
from semiclassical_tpu_torch import cli, units
from semiclassical_tpu_torch.io.extxyz import write_extxyz
from semiclassical_tpu_torch.io.results import (accumulate_results,
                                                init_results)

TABLES = ("autocorrelation.dat", "ic_correlation.dat", "ic_rate.dat",
          "spectrum.dat")


@pytest.fixture()
def results_file(tmp_path, monkeypatch):
    """A results npz with error bars, rates and the spectrum."""
    monkeypatch.chdir(tmp_path)
    times = np.linspace(0.0, 400.0, 64)
    init_results("correlations.npz", "HK", times, adiabatic_gap=0.2,
                 zero_point_energy=0.05)
    cauto = np.exp(-0.01 * times) * np.exp(1j * 0.3 * times)
    cauto[0] = 1.0
    kic = 1e-8 * np.exp(-0.02 * times) * np.exp(0.1j * times)
    accumulate_results("correlations.npz", cauto, kic, 1000,
                       autocorrelation_stderr=np.full(64, 1e-3),
                       ic_correlation_stderr=np.full(64, 1e-10))
    cli.calculate_rates({"task": "rates", "broadening": "gaussian",
                         "hwhmG_ev": 0.1})
    cli.calculate_spectrum({"task": "spectrum", "broadening": "gaussian",
                            "hwhmG_ev": 0.1})
    return "correlations.npz"


def test_export_tables_equal_jax(results_file, tmp_path):
    """`export` writes the JAX CLI's four tables byte for byte."""
    os.mkdir("jax")
    os.chdir("jax")
    jax_cli._export_tables(os.path.join("..", results_file))
    os.chdir("..")
    assert cli.main(["export", results_file]) == 0
    for name in TABLES:
        assert filecmp.cmp(name, os.path.join("jax", name), shallow=False), \
            name
    auto = np.loadtxt("autocorrelation.dat")
    assert auto.shape == (64, 3)


def test_export_without_rates_writes_two_tables(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    init_results("c.npz", "WM", np.linspace(0.0, 1.0, 8), np.nan, 0.01)
    accumulate_results("c.npz", np.ones(8, complex), np.zeros(8, complex), 10)
    cli._export_tables("c.npz")
    assert sorted(f for f in os.listdir(".") if f.endswith(".dat")) == [
        "autocorrelation.dat", "ic_correlation.dat"]


@pytest.mark.parametrize("rates", [True, False], ids=["rates", "no_rates"])
def test_show_prints_the_jax_text(results_file, capsys, rates):
    if not rates:
        data = dict(np.load(results_file))
        for key in [k for k in data if "rate" in k or "spectrum" in k
                    or k in ("energies", "broadening", "hwhmG", "hwhmL")]:
            data.pop(key)
        np.savez(results_file, **data)
    jax_cli._show_information(results_file)
    ref = capsys.readouterr().out
    assert cli.main(["show", results_file]) == 0
    got = capsys.readouterr().out
    assert got == ref
    assert "propagator" in got and "HK" in got
    assert ("IC rate" in got) == rates


def test_plot_save_writes_an_image(results_file, tmp_path):
    """`plot --save` renders under the Agg backend without a display."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "fig.png"
    assert cli.main(["plot", results_file, "--save", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_extxyz_equals_jax_writer(tmp_path):
    rng = np.random.default_rng(0)
    numbers = [6, 1, 1, 1]
    q = rng.random((3, 12))
    p = rng.random((3, 12))
    for append in (False, True):
        write_extxyz(tmp_path / "port.xyz", numbers, q, p, append=append)
        jax_write_extxyz(tmp_path / "jax.xyz", numbers, q, p, append=append)
    text = (tmp_path / "port.xyz").read_text()
    assert text == (tmp_path / "jax.xyz").read_text()
    lines = text.splitlines()
    assert len(lines) == 2 * 3 * (2 + 4) and lines[0] == "4"
    first = lines[2].split()
    assert first[0] == "C"
    assert np.isclose(float(first[1]), q[0, 0] * units.bohr_to_angs)


def _methylium_task(ref_data, **keys):
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")
    task = {"task": "dynamics",
            "potential": {"type": "harmonic",
                          "ground": str(base / "opt_freq_s0.fchk"),
                          "excited": str(base / "opt_freq_s1.fchk"),
                          "coupling": str(base / "opt_freq_s1.fchk")},
            "propagator": "HK", "batch_size": 16, "num_trajectories": 32,
            "num_steps": 5, "time_step_fs": 0.005, "manual_seed": 0,
            "results": {"correlations": "correlations.npz"}}
    task.update(keys)
    return task


def _frames(path):
    lines = open(path).read().splitlines()
    nat = int(lines[0])
    return np.array([[float(x) for x in line.split()[1:4]]
                     for i, line in enumerate(lines)
                     if i % (nat + 2) >= 2]).reshape(-1, nat, 3)


@pytest.mark.parametrize("integrator", ["rk4", "exact"])
def test_export_initial_and_final(ref_data, tmp_path, monkeypatch,
                                  integrator):
    """One frame per trajectory of every repetition (appended), the initial
    frames at the sampled positions and the final ones moved."""
    monkeypatch.chdir(tmp_path)
    task = _methylium_task(ref_data, integrator=integrator,
                           export_initial="initial.xyz",
                           export_final="final.xyz")
    cli.run_semiclassical_dynamics(task, device="cpu")
    initial, final = _frames("initial.xyz"), _frames("final.xyz")
    assert initial.shape == final.shape == (32, 4, 3)
    assert np.abs(final - initial).max() > 1e-6
    assert [line.split()[0] for line in
            open("initial.xyz").read().splitlines()[2:6]] == ["H", "C", "H",
                                                             "H"]


def test_export_is_skipped_for_the_as_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("1000.0  0.20  0.5  0.02\n 600.0  0.30  0.8  0.02\n")
    cli.run_semiclassical_dynamics(
        {"task": "dynamics",
         "potential": {"type": "anharmonic AS", "model_file": "AS_model.dat"},
         "batch_size": 16, "num_trajectories": 16, "num_steps": 4,
         "time_step_fs": 0.05, "manual_seed": 1,
         "export_initial": "initial.xyz", "export_final": "final.xyz",
         "results": {"correlations": "c.npz"}}, device="cpu")
    assert not os.path.exists("initial.xyz")
    assert not os.path.exists("final.xyz")


def test_watchdog_dumps_trajectories_on_blowup(ref_data, tmp_path,
                                               monkeypatch):
    """A run that blows up (50 fs steps drive the C-H modes unstable, the
    energy guard fires) writes current_trajectories.xyz before the error
    propagates."""
    monkeypatch.chdir(tmp_path)
    task = _methylium_task(ref_data, batch_size=16, num_trajectories=16,
                           num_steps=40, time_step_fs=50.0)
    with pytest.raises(RuntimeError):
        cli.run_semiclassical_dynamics(task, device="cpu")
    dump = tmp_path / "current_trajectories.xyz"
    assert dump.exists(), "watchdog did not write current_trajectories.xyz"
    lines = dump.read_text().splitlines()
    assert lines[0].strip() == "4" and len(lines) == 16 * 6
