# coding: utf-8
"""The port's separable path (anharmonic AS / Morse models: diagonal
Hessians, diagonal widths, the diagonal monodromy representation) against
the JAX package at float64 on the CPU, and against the AS oracles of
tests/test_as_model.py.

Inputs are made with numpy and go into both packages; the JAX packs cross
over through `semiclassical_tpu_torch.convert`. Tolerances: the potentials
at 1e-13 relative, one RK4 step at 1e-12, the HK diagonal prefactor at
1e-10, C(t) and k~ic(t) of `propagate` and of the CLI at 1e-8 of their
largest value, the CLI's rate at 1e-6; the oracles at test_as_model.py's
own tolerances.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu import units
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import cli, convert
from semiclassical_tpu_torch import sampling as port_sampling
from semiclassical_tpu_torch.config import ConfigurationError
from semiclassical_tpu_torch.potentials import (MorsePotential,
                                                NonHarmonicPotential)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator)
from semiclassical_tpu_torch.propagation import eom, hk
from semiclassical_tpu_torch.propagation.state import TrajState

NTRAJ = 64
NSTEPS = 20


def _fields(obj):
    """The fields of a JAX pack as numpy arrays (nested packs as dicts)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _random_model(d, seed, chi=0.02):
    """An AS model as examples/as_model/make_model.py draws it: omegas
    unsorted, so the sampling basis U permutes the modes."""
    rng = np.random.default_rng(seed)
    omega = rng.uniform(200.0, 3000.0, size=d) / units.hartree_to_wavenumbers
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    return omega, np.full(d, chi), nac, np.sqrt(2 * S / omega)


def _as_model(ref_data, chi):
    """The 5-mode AS model of tests/data (test_as_model.py's loader)."""
    model = (ref_data / "AnharmonicAS" / "5modes"
             / f"AS_model_chi{chi:.2f}.dat")
    if not model.exists():
        pytest.skip(f"{model} not available")
    data = np.loadtxt(model)
    omega = data[:, 0] / units.hartree_to_wavenumbers
    S, nac = data[:, 1], data[:, 2]
    dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    return omega, data[:, 3], nac, dQ, np.abs(S), model


POTENTIALS = {
    "morse": lambda dev, d: MorsePotential.create(*_random_model(d, 1)[:3],
                                                  device=dev),
    "morse_harmonic": lambda dev, d: MorsePotential.create(
        *_random_model(d, 2, chi=0.0)[:3], device=dev),
    "morse_mixed_chi": lambda dev, d: MorsePotential.create(
        _random_model(d, 3)[0], np.array([0.02, 0.0, 0.01, 0.0, 0.05, 0.03]),
        _random_model(d, 3)[2], device=dev),
    "nonharmonic": lambda dev, d: NonHarmonicPotential.create(dim=d,
                                                              device=dev),
}
JAX_POTENTIALS = {
    "morse": lambda d: jax_potentials.MorsePotential.create(
        *_random_model(d, 1)[:3]),
    "morse_harmonic": lambda d: jax_potentials.MorsePotential.create(
        *_random_model(d, 2, chi=0.0)[:3]),
    "morse_mixed_chi": lambda d: jax_potentials.MorsePotential.create(
        _random_model(d, 3)[0], np.array([0.02, 0.0, 0.01, 0.0, 0.05, 0.03]),
        _random_model(d, 3)[2]),
    "nonharmonic": lambda d: jax_potentials.NonHarmonicPotential.create(
        dim=d),
}


@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_local_expansion_matches_jax(name):
    d = 6
    pot = POTENTIALS[name]("cpu", d)
    pot_j = JAX_POTENTIALS[name](d)
    q = np.random.default_rng(7).standard_normal((40, d)) * 3.0
    v, g, h = pot.local_expansion(torch.from_numpy(q))
    vj, gj, hj = pot_j.local_expansion(jnp.asarray(q))
    for got, ref in ((v, vj), (g, gj), (h.diag, hj.diag)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
    np.testing.assert_array_equal(
        pot.derivative_coupling_1st(torch.from_numpy(q)).numpy(),
        np.asarray(pot_j.derivative_coupling_1st(jnp.asarray(q))))
    if name.startswith("morse"):
        conv = convert.morse_potential(_fields(pot_j), "cpu")
        assert conv.harmonic == pot.harmonic
        np.testing.assert_array_equal(conv.a.numpy(), pot.a.numpy())
    else:
        conv = convert.nonharmonic_potential(_fields(pot_j), "cpu")
        np.testing.assert_array_equal(conv.b.numpy(), pot.b.numpy())
    v_conv = conv.local_expansion(torch.from_numpy(q))[0]
    np.testing.assert_array_equal(v_conv.numpy(), v.numpy())


@pytest.mark.parametrize("key, value, named", [
    ("hessian_eval", "taylor", "'taylor'"), ("hessian_eval", "step", "'step'"),
    ("taylor_every", 4, "'taylor_every'")])
def test_reduced_cost_hessian_is_refused(key, value, named):
    """The JAX package's reduced-cost Hessian modes of the AS potential are
    refused by name before anything runs."""
    task = {"task": "dynamics", "potential": {
        "type": "anharmonic AS", "model_file": "AS_model.dat", key: value}}
    with pytest.raises(ConfigurationError, match=f"{named}.*not ported"):
        cli.check_slice(task)


def _diag_state_pair(d, n, seed):
    """A JAX diagonal-monodromy state after a few RK4 steps of the random
    Morse model, and the port's copy of it."""
    pot_j = JAX_POTENTIALS["morse"](d)
    omega, _, _, dQ = _random_model(d, 1)
    rng = np.random.default_rng(seed)
    q = dQ + rng.standard_normal((n, d)) / np.sqrt(2 * omega)
    p = rng.standard_normal((n, d)) * np.sqrt(omega / 2)
    state = JaxTrajState.initial(jnp.asarray(q), jnp.asarray(p),
                                 diag_monodromy=True)
    for _ in range(3):
        state, _ = jax_eom.rk4_step(state, pot_j, 5.0)
    return pot_j, state, convert.traj_state(_fields(state), "cpu")


@pytest.mark.parametrize("name", ["morse", "morse_mixed_chi",
                                  "morse_harmonic", "nonharmonic"])
def test_diag_rk4_step_matches_jax(name):
    """One RK4 step of the diagonal representation, every field at 1e-12
    of its largest entry; the derivative as well."""
    d = 6
    _, state_j, state = _diag_state_pair(d, 50, seed=5)
    pot, pot_j = POTENTIALS[name]("cpu", d), JAX_POTENTIALS[name](d)
    assert state.diag_monodromy and state.Z.shape == (4, 50, d)
    new_j, e_j = jax_eom.rk4_step(state_j, pot_j, 5.0)
    new, e = eom.rk4_step(state, pot, 5.0)
    ref = convert.traj_state(_fields(new_j), "cpu")
    for f in ("q", "p", "Z", "S"):
        got, want = getattr(new, f).numpy(), getattr(ref, f).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), f
    assert abs(float(e) - float(e_j)) <= 1e-12 * abs(float(e_j))
    dstate, _ = eom.state_derivative(state, pot)
    dref, _ = jax_eom.state_derivative(state_j, pot_j)
    dref = convert.traj_state(_fields(dref), "cpu")
    np.testing.assert_allclose(dstate.Z.numpy(), dref.Z.numpy(), rtol=1e-13,
                               atol=1e-13 * np.abs(dref.Z.numpy()).max())


def test_dense_expansion_of_diag_state():
    _, state_j, state = _diag_state_pair(4, 8, seed=6)
    dense = convert.traj_state(
        _fields(JaxTrajState(state_j.q, state_j.p,
                             *state_j.dense_monodromy(), state_j.S)), "cpu")
    np.testing.assert_array_equal(state.dense_Z().numpy(), dense.Z.numpy())


@pytest.mark.parametrize("widths", ["diagonal", "dense"])
def test_hk_prefactor_matches_jax(widths):
    """The HK prefactor C^2 on a diagonal state with unsorted omegas: the
    permutation-collapsed diagonal path (diagonal widths) and the
    dense-factor path on the expanded state (a rotated width matrix), at
    1e-10; the packs' separable fields equal the JAX package's."""
    d = 6
    pot_j, state_j, state = _diag_state_pair(d, 40, seed=8)
    omega, _, _, dQ = _random_model(d, 1)
    G = np.diag(omega)
    if widths == "dense":
        Q, _ = np.linalg.qr(np.random.default_rng(2).standard_normal((d, d)))
        G = Q @ G @ Q.T
    sp = jax_sampling.SamplingParams.create(dQ, 0 * dQ, G, G)
    params_j = jax_hk._build_hk_params(G, G, G, dQ, 0 * dQ,
                                       np.asarray(sp.U), np.asarray(sp.iGi0),
                                       jnp.float64)
    params = convert.hk_params(_fields(params_j), "cpu")
    port = hk.build_hk_params(G, G, G, dQ, 0 * dQ, np.asarray(sp.U),
                              np.asarray(sp.iGi0), "cpu")
    assert params_j.factors_diag == port.factors_diag == (widths == "diagonal")
    assert (params_j.diag_ka is not None) == (port.diag_k is not None)
    if widths == "diagonal":
        assert not (np.diff(np.argmax(np.abs(np.asarray(sp.U)), 0)) > 0).all()
        np.testing.assert_allclose(port.diag_k.numpy(),
                                   params.diag_k.numpy(), rtol=1e-14)
        np.testing.assert_allclose(port.R_diag.numpy(),
                                   np.asarray(params_j.R_diag), rtol=1e-14)
    ref = np.asarray(jax_hk.hk_prefactor_det(params_j, state_j))
    for pk in (port, params):
        got = hk.hk_prefactor_det(pk, state).numpy()
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def test_hk_prefactor_rank_deficient_diag():
    """Diagonal widths with a zero mode: the factors are diagonal but not
    square, so the prefactor uses the K matrices (no permutation
    collapse)."""
    d = 5
    omega = np.array([0.004, 0.0, 0.011, 0.007, 0.002])
    G = np.diag(omega)
    q0 = np.array([1.0, 0.0, -0.5, 0.3, 2.0])
    sp = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    assert sp.rank == 4
    params_j = jax_hk._build_hk_params(G, G, G, q0, 0 * q0,
                                       np.asarray(sp.U), np.asarray(sp.iGi0),
                                       jnp.float64)
    port = hk.build_hk_params(G, G, G, q0, 0 * q0, np.asarray(sp.U),
                              np.asarray(sp.iGi0), "cpu")
    assert port.factors_diag and port.diag_k is None
    rng = np.random.default_rng(4)
    planes = 1.0 + 0.3 * rng.standard_normal((4, 30, d))
    state_j = JaxTrajState(jnp.zeros((30, d)), jnp.zeros((30, d)),
                           *map(jnp.asarray, planes), jnp.zeros(30))
    state = TrajState(torch.zeros(30, d, dtype=torch.float64),
                      torch.zeros(30, d, dtype=torch.float64),
                      torch.from_numpy(planes),
                      torch.zeros(30, dtype=torch.float64))
    ref = np.asarray(jax_hk.hk_prefactor_det(params_j, state_j))
    got = hk.hk_prefactor_det(port, state).numpy()
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.fixture(scope="module")
def as5(ref_data):
    omega, chi, nac, dQ, _, _ = _as_model(ref_data, 0.02)
    G = np.diag(omega)
    sp = port_sampling.SamplingParams.create(dQ, 0 * dQ, G, G, "cpu")
    normals = np.random.default_rng(17).standard_normal((NTRAJ, 2 * sp.rank))
    return dict(omega=omega, G=G, dQ=dQ, en0=float(np.sum(0.5 * omega)),
                pot=MorsePotential.create(omega, chi, nac, device="cpu"),
                pot_j=jax_potentials.MorsePotential.create(omega, chi, nac),
                normals=normals, dt=150.0 / units.autime_to_fs / 40.0 / 99)


def jax_propagator(s, monkeypatch, cls, *args):
    """A JAX propagator whose batch starts at the injected normals."""
    sp = jax_sampling.SamplingParams.create(s["dQ"], 0 * s["dQ"], s["G"],
                                            s["G"])
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method:
                        jnp.asarray(s["normals"]))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp, None, NTRAJ)
    prop = cls(s["G"], s["G"], *args)
    prop.initial_conditions(s["dQ"], 0 * s["dQ"], s["G"], ntraj=NTRAJ,
                            key=0, potential=s["pot_j"])
    prop.state = JaxTrajState.initial(qi, pi, diag_monodromy=True)
    make_bc = (jax_wm.wm_batch_constants if cls is JaxWM
               else jax_hk.hk_batch_constants)
    prop._bc = make_bc(prop.params, qi, pi, log_prob, potential=s["pot_j"])
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)
    return prop


def port_propagator(s, cls, *args):
    prop = cls(s["G"], s["G"], *args, device="cpu")
    prop.initial_conditions(s["dQ"], 0 * s["dQ"], s["G"], s["pot"],
                            ntraj=NTRAJ,
                            normals=torch.from_numpy(s["normals"]))
    assert prop.state.diag_monodromy
    return prop


def test_hk_propagate_matches_jax(as5, monkeypatch):
    """HK on the 5-mode AS model: C(t) and k~ic(t) over 20 steps at 64
    trajectories with the same normals, at 1e-8."""
    prop_j = jax_propagator(as5, monkeypatch, JaxHK)
    prop = port_propagator(as5, HermanKlukPropagator)
    cj, kj = prop_j.propagate(as5["pot_j"], as5["dt"], NSTEPS,
                              energy0_es=as5["en0"])
    c, k = prop.propagate(as5["pot"], as5["dt"], NSTEPS,
                          energy0_es=as5["en0"])
    assert abs(c[0] - 1.0) < 1e-3
    np.testing.assert_allclose(c, cj, rtol=0, atol=1e-8 * np.abs(cj).max())
    np.testing.assert_allclose(k, kj, rtol=0, atol=1e-8 * np.abs(kj).max())
    np.testing.assert_array_equal(
        prop.tracker.signs.numpy(),
        np.asarray(prop_j.trackers["prefactorC"].signs))


# --- the AS oracles of tests/test_as_model.py, through the port ---------

ORACLE_NTRAJ = 20000


def _oracle(ref_data, chi):
    omega, chi_v, nac, dQ, S, _ = _as_model(ref_data, chi)
    nt = 4000 // 40
    times = np.linspace(0.0, 150.0 / units.autime_to_fs / 40.0, nt)
    if chi == 0.0:
        # closed-form k~ic(t) of the harmonic AS model
        A = nac * np.sqrt(omega / (2 * S)) * np.sign(dQ)
        B = -nac * np.sqrt(omega * S / 2) * np.sign(dQ)
        Xt = S[None, :] * np.exp(-1j * omega[None, :] * times[:, None])
        ic_qm = (np.prod(np.exp(-S + Xt), axis=1)
                 * (np.sum(A * Xt + B, axis=1) ** 2
                    + np.sum(A**2 * Xt, axis=1)))
    else:
        table = (ref_data / "AnharmonicAS" / "5modes"
                 / f"ic_correlation_chi{chi:.2f}_T0.001.dat")
        if not table.exists():
            pytest.skip(f"{table} not available")
        ic = np.loadtxt(table)
        tgrid = ic[:, 0] / units.autime_to_fs
        ic_qm = (np.interp(times, tgrid, ic[:, 1])
                 + 1j * np.interp(times, tgrid, ic[:, 2]))
    return omega, chi_v, nac, dQ, times, ic_qm


@pytest.fixture()
def one_torch_thread():
    """The oracle runs' (20,000, 5) tensors are large enough for PyTorch's
    intra-op threads, which oversubscribe the cores when the suite runs in
    several worker processes (minutes per test); one thread keeps each run
    at seconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("prop_name", ["HK", "WM"])
@pytest.mark.parametrize("chi", [0.0, 0.02], ids=["harmonic", "anharmonic"])
def test_as_oracles(ref_data, one_torch_thread, prop_name, chi):
    """The port against the analytic harmonic k~ic and the chi = 0.02 QM
    table at 20,000 trajectories x 100 steps (tests/test_as_model.py's
    runs and tolerances; WM at alpha = beta = 500)."""
    omega, chi_v, nac, dQ, times, ic_qm = _oracle(ref_data, chi)
    G = np.diag(omega)
    pot = MorsePotential.create(omega, chi_v, nac, device="cpu")
    if prop_name == "WM":
        prop = WaltonManolopoulosPropagator(G, G, 500.0, 500.0, device="cpu")
    else:
        prop = HermanKlukPropagator(G, G, device="cpu")
    gen = torch.Generator().manual_seed(0)
    prop.initial_conditions(dQ, 0 * dQ, G, pot, ntraj=ORACLE_NTRAJ,
                            generator=gen)
    cauto, kic = prop.propagate(pot, times[1] - times[0], len(times),
                                energy0_es=float(np.sum(0.5 * omega)))
    if chi == 0.0:
        assert abs(cauto[0] - 1.0) < (1e-3 if prop_name == "HK" else 2e-2)
    assert np.allclose(kic, ic_qm, rtol=0.1, atol=0.02 * np.abs(ic_qm).max())


# --- the CLI against the JAX package's CLI -------------------------------

@pytest.mark.parametrize("prop_name", ["HK", "WM"])
def test_cli_matches_jax(ref_data, tmp_path, monkeypatch, prop_name):
    """`dynamics` + `rates` of a 5-mode AS task (two repetitions of 32
    trajectories, 20 steps) through both CLIs with the same normals (one
    draw for every repetition: the JAX package traces its draw once): C(t)
    and k~ic(t) at 1e-8, the rate at 1e-6 of their largest values; the
    npz keys, types and the NaN adiabatic gap alike."""
    *_, model = _as_model(ref_data, 0.02)
    draw = np.random.default_rng(23).standard_normal((32, 10))
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS", "model_file": str(model)},
            "propagator": prop_name, "batch_size": 32,
            "num_trajectories": 64, "num_steps": NSTEPS,
            "time_step_fs": 0.05, "manual_seed": 3,
            "results": {"correlations": str(tmp_path / "port.npz")}}
    if prop_name == "WM":
        task["cell_width"] = 500.0
    rates = {"task": "rates", "broadening": "gaussian", "hwhmG_ev": 0.01}

    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method: jnp.asarray(draw))
    jax_task = dict(task, results={"correlations": str(tmp_path / "j.npz")})
    jax_cli.run_semiclassical_dynamics(jax_task, num_devices=1,
                                       precision="f64")
    jax_cli.calculate_rates(dict(rates, correlations=str(tmp_path / "j.npz"),
                                 rates=str(tmp_path / "j.npz")))

    sample = hk.sample_initial_conditions
    monkeypatch.setattr(hk, "sample_initial_conditions",
                        lambda params, ntraj, generator=None, normals=None:
                        sample(params, ntraj, normals=torch.from_numpy(draw)))
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [task, dict(
        rates, correlations=task["results"]["correlations"],
        rates=task["results"]["correlations"])]}))
    assert cli.main(["dynamics", str(path), "--device", "cpu"]) == 0
    assert cli.main(["rates", str(path)]) == 0

    got = dict(np.load(tmp_path / "port.npz"))
    ref = dict(np.load(tmp_path / "j.npz"))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and \
            got[key].dtype == ref[key].dtype, key
    assert np.isnan(got["adiabatic_gap"]) and np.isnan(ref["adiabatic_gap"])
    assert int(got["trajectories"]) == 64
    assert float(got["zero_point_energy"]) == float(ref["zero_point_energy"])
    for key, tol in (("autocorrelation", 1e-8), ("ic_correlation", 1e-8),
                     ("ic_rate", 1e-6)):
        assert np.abs(got[key] - ref[key]).max() <= tol * np.abs(
            ref[key]).max(), key
