# coding: utf-8
"""The port's CLI (`python -m semiclassical_tpu_torch.cli dynamics|rates`)
on the CPU: methylium at 64 trajectories x 20 steps end to end with HK and
with WM, the npz contract against the JAX CLI's file for the same task,
and the refusals — keywords outside the ported slice, an unknown
integrator, an odd antithetic micro-batch under error bars, an unknown
precision mode, and a CUDA run without CUDA.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch.config import ConfigurationError

EXAMPLE = (pathlib.Path(__file__).resolve().parents[1] / "examples"
           / "methylium_AH" / "semi.json")


@pytest.fixture()
def config(ref_data, tmp_path):
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")
    with open(EXAMPLE) as f:
        cfg = json.load(f)
    npz = str(tmp_path / "correlations.npz")
    for task in cfg["semi"]:
        if task["task"] == "dynamics":
            task["potential"].update(
                ground=str(base / "opt_freq_s0.fchk"),
                excited=str(base / "opt_freq_s1.fchk"),
                coupling=str(base / "opt_freq_s1.fchk"))
            task.update(num_trajectories=64, batch_size=32, num_steps=20,
                        manual_seed=5)
            task["results"]["correlations"] = npz
        else:
            task.update(correlations=npz, rates=npz)
    return cfg


def _write(cfg, path):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _jax_npz(cfg, tmp_path):
    """The JAX CLI's npz for the same task (f64 on one CPU device)."""
    dyn, rates = (dict(t) for t in cfg["semi"])
    npz = str(tmp_path / "jax.npz")
    dyn["results"] = dict(dyn["results"], correlations=npz)
    jax_cli.run_semiclassical_dynamics(dyn, num_devices=1, precision="f64")
    jax_cli.calculate_rates(dict(rates, correlations=npz, rates=npz))
    return dict(np.load(npz))


def test_dynamics_and_rates_on_cpu(config, tmp_path):
    path = _write(config, tmp_path / "semi.json")
    assert cli.main(["dynamics", path, "--device", "cpu"]) == 0
    assert cli.main(["rates", path]) == 0
    data = dict(np.load(config["semi"][0]["results"]["correlations"]))
    ref = _jax_npz(config, tmp_path)

    assert sorted(data) == sorted(ref)
    for key in ref:
        assert data[key].shape == ref[key].shape, key
        assert data[key].dtype == ref[key].dtype, key
    assert int(data["trajectories"]) == 64
    np.testing.assert_array_equal(data["times"], ref["times"])
    np.testing.assert_array_equal(data["energies"], ref["energies"])
    assert abs(float(data["adiabatic_gap"]) - float(ref["adiabatic_gap"])) < 1e-10
    assert float(data["zero_point_energy"]) == float(ref["zero_point_energy"])
    # the check accumulate_results makes: C(0) = <phi(0)|phi(0)> = 1
    assert abs(data["autocorrelation"][0] - 1.0) < 1e-3
    assert np.isfinite(data["autocorrelation"]).all()
    assert np.isfinite(data["ic_rate"]).all()


OUT_OF_SLICE = [
    ("potential.type", "gdml"),
    ("potential.type", "anharmonic AS"),
]


@pytest.mark.parametrize("key, value", OUT_OF_SLICE,
                         ids=[f"{k}={v}" for k, v in OUT_OF_SLICE])
def test_out_of_slice_keyword_raises(config, tmp_path, key, value):
    task = config["semi"][0]
    if key == "potential.type":
        task["potential"]["type"] = value
        pattern = f"'{value}'.*not ported"
        if value == "anharmonic AS":
            # the AS model is ported with every hessian_eval the JAX
            # package knows; an unknown one is refused by name
            task["potential"] = {"type": value, "model_file": "model.dat",
                                 "hessian_eval": "midpoint"}
            pattern = "hessian_eval 'midpoint' is unknown"
        if value == "gdml":
            # sGDML is ported with a float32 or float64 Hessian only
            task["potential"]["hess_dtype"] = "bfloat16"
            pattern = "'bfloat16'.*not ported"
    path = _write(config, tmp_path / "semi.json")
    with pytest.raises(ConfigurationError, match=pattern):
        cli.main(["dynamics", path, "--device", "cpu"])


def test_unknown_integrator_raises(config, tmp_path):
    """An integrator name other than 'rk4' and 'exact' is refused up front,
    naming it, before the npz is written."""
    config["semi"][0]["integrator"] = "leapfrog"
    path = _write(config, tmp_path / "semi.json")
    with pytest.raises(ConfigurationError, match="'leapfrog' is unknown"):
        cli.main(["dynamics", path, "--device", "cpu"])
    assert not pathlib.Path(
        config["semi"][0]["results"]["correlations"]).exists()


def test_wm_dynamics_and_rates_on_cpu(config, tmp_path):
    config["semi"][0].update(propagator="WM", cell_width=10000.0)
    path = _write(config, tmp_path / "semi.json")
    assert cli.main(["dynamics", path, "--device", "cpu"]) == 0
    assert cli.main(["rates", path]) == 0
    data = dict(np.load(config["semi"][0]["results"]["correlations"]))
    assert str(data["propagator"]) == "WM"
    assert int(data["trajectories"]) == 64
    assert data["autocorrelation"].shape == (20,)
    assert abs(data["autocorrelation"][0] - 1.0) < 1e-3
    assert np.isfinite(data["ic_correlation"]).all()
    assert data["ic_rate"].size and np.isfinite(data["ic_rate"]).all()


@pytest.mark.parametrize("propagator", ["HK", "WM"])
def test_dynamics_log_names_the_run(config, tmp_path, caplog, propagator):
    """The run's header lines of the JAX CLI's log: total trajectories,
    propagator and integrator, in its wording."""
    config["semi"][0].update(propagator=propagator, num_steps=3)
    path = _write(config, tmp_path / "semi.json")
    with caplog.at_level("INFO", logger=cli.logger.name):
        assert cli.main(["dynamics", path, "--device", "cpu"]) == 0
    lines = [r.getMessage() for r in caplog.records]
    assert "  total number of trajectories              : 64" in lines
    assert f"  propagator                                : {propagator}" in lines
    assert "  integrator                                : rk4" in lines


def test_wm_micro_batch_raises(config, tmp_path):
    """An odd micro-batch under antithetic error bars is refused up front,
    before the npz is written: interleaved +-pairs would straddle the
    sub-batches."""
    config["semi"][0].update(propagator="WM", micro_batch=1,
                             sampling="antithetic", error_bars=True)
    path = _write(config, tmp_path / "semi.json")
    with pytest.raises(ConfigurationError, match="'micro_batch'.*odd"):
        cli.main(["dynamics", path, "--device", "cpu"])
    assert not pathlib.Path(
        config["semi"][0]["results"]["correlations"]).exists()


def test_unknown_precision_raises(config, tmp_path):
    """A precision mode other than f64, mixed, comp32 and f32 is refused
    up front, naming it, before the npz is written."""
    path = _write(config, tmp_path / "semi.json")
    with pytest.raises(ConfigurationError, match="precision 'bf16'"):
        cli.main(["dynamics", path, "--device", "cpu", "--precision", "bf16"])
    assert not pathlib.Path(
        config["semi"][0]["results"]["correlations"]).exists()


def test_cuda_without_cuda_raises(config, tmp_path, monkeypatch):
    """The default device is cuda; without it the CLI raises and does not
    carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(config, tmp_path / "semi.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["dynamics", path])
    assert not pathlib.Path(
        config["semi"][0]["results"]["correlations"]).exists()
