# coding: utf-8
"""The port's exact integrators (`propagation.exact_morse`,
`propagation.exact_harmonic`, `integrator="exact"` of the HK and WM
propagators and the CLI) against the JAX package at float64 on the CPU,
and the twins of tests/test_exact_morse.py and tests/test_exact_harmonic.py
that need no mesh and no comp32.

Inputs are made with numpy and go into both packages (JAX states cross
over through `convert.traj_state`). Tolerances: the Morse map over 25 steps
(q, p, the four monodromy planes, S) at 1e-12 of each field's largest
value, also from M0 != identity and with routed rows (a NaN row among
them); the harmonic map's constants at 1e-13 and 20 methylium steps at
1e-12; C(t), k~ic(t) and their stderr of `propagate` at 1e-10 of their
largest value; the CLI npz at 1e-10 (the rate at 1e-8); the twins at the
JAX tests' own tolerances.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu import units
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation import exact_harmonic as jax_eh
from semiclassical_tpu.propagation import exact_morse as jax_em
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu.pytree import replace as jax_replace
from semiclassical_tpu_torch import cli, convert
from semiclassical_tpu_torch import sampling as port_sampling
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                MorsePotential,
                                                NonHarmonicPotential,
                                                minimize)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator)
from semiclassical_tpu_torch.propagation import exact_harmonic as eh
from semiclassical_tpu_torch.propagation import exact_morse as em
from semiclassical_tpu_torch.propagation.eom import rk4_step
from semiclassical_tpu_torch.propagation.state import TrajState

NTRAJ = 64
NSTEPS = 20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _port_state(state_j):
    return convert.traj_state(_fields(state_j), "cpu")


def _morse(d=6, seed=0, chi=0.02):
    """(port potential, JAX potential, q0, Gamma, omega): the random
    separable Morse model of tests/test_exact_morse.py."""
    rng = np.random.default_rng(seed)
    omega = rng.uniform(300.0, 2800.0, size=d) / 219474.63
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    return (MorsePotential.create(omega, np.full(d, chi), nac, device="cpu"),
            jax_potentials.MorsePotential.create(omega, np.full(d, chi), nac),
            np.sqrt(2 * S / omega), np.diag(omega), omega)


def _harmonic(d=4, seed=0, spectrum=None):
    """(port, JAX) synthetic molecular-harmonic PES of
    tests/test_exact_harmonic.py: mass-weighted frequencies `spectrum`
    (zero and negative entries: translation and saddle directions)."""
    rng = np.random.default_rng(seed)
    mass = rng.uniform(800.0, 2000.0, size=d)
    if spectrum is None:
        spectrum = rng.uniform(0.004, 0.02, size=d) ** 2
    Vv, _ = np.linalg.qr(rng.standard_normal((d, d)))
    sm = np.sqrt(mass)
    H = sm[:, None] * ((Vv * spectrum) @ Vv.T) * sm[None, :]
    f = dict(pos0=rng.standard_normal(d), energy0=0.5,
             grad0=1.0e-3 * rng.standard_normal(d), hess0=0.5 * (H + H.T),
             nac0=rng.uniform(-1.0, 1.0, size=d), mass=mass, origin=0.123)
    return (MolecularHarmonicPotential.from_arrays(**f, device="cpu"),
            jax_potentials.MolecularHarmonicPotential(
                **{k: jnp.asarray(v) for k, v in f.items()}))


def _dense_state(pot, n=16, seed=1):
    """A JAX dense-monodromy state around the expansion center."""
    d = pot.hess0.shape[0]
    rng = np.random.default_rng(seed)
    eye = jnp.broadcast_to(jnp.eye(d), (n, d, d))
    return JaxTrajState(
        q=jnp.asarray(np.asarray(pot.pos0)[None, :]
                      + 0.3 * rng.standard_normal((n, d))),
        p=jnp.asarray(5.0 * rng.standard_normal((n, d))),
        Mqq=eye, Mqp=jnp.zeros((n, d, d)), Mpq=jnp.zeros((n, d, d)),
        Mpp=eye, S=jnp.zeros(n))


def _methylium(ref_data):
    """(port potential, JAX potential, q0, Gamma_0, ZPE) of the methylium
    example, each minimised."""
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")

    def read(cls, name):
        with open(base / name) as f:
            return cls(f)

    x0, G0, zpe = read(FormattedCheckpointFile,
                       "opt_freq_s1.fchk").vibrational_groundstate()
    pot = minimize(MolecularHarmonicPotential.from_fchk(
        read(FormattedCheckpointFile, "opt_freq_s0.fchk"),
        read(FormattedCheckpointFile, "opt_freq_s1.fchk"), device="cpu"), x0)
    pot_j = jax_potentials.minimize(
        jax_potentials.MolecularHarmonicPotential.from_fchk(
            read(JaxFchk, "opt_freq_s0.fchk"),
            read(JaxFchk, "opt_freq_s1.fchk")), jnp.asarray(x0))
    return pot, pot_j, np.asarray(x0), G0, zpe


def _close(got, ref, tol, what=""):
    """Within `tol` of the reference's largest finite value, NaN where the
    reference is NaN."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    if nan.all():
        return
    scale = max(np.abs(ref[~nan]).max(), 1e-300)
    assert np.abs(got[~nan] - ref[~nan]).max() <= tol * scale, what


def _assert_state(got, ref_j, tol):
    """A port state against a JAX state (diagonal or dense monodromy)."""
    ref = _port_state(ref_j)
    for name in ("q", "p", "S"):
        _close(getattr(got, name).numpy(), getattr(ref, name).numpy(), tol,
               name)
    for name in ("Mqq", "Mqp", "Mpq", "Mpp"):
        _close(getattr(got, name).numpy(), getattr(ref, name).numpy(), tol,
               name)


# --- the maps against the JAX package -------------------------------------

def _morse_batch(pot_j, q0, omega, n=32, seed=7, hot=False):
    rng = np.random.default_rng(seed)
    d = q0.size
    qi = q0[None, :] + rng.normal(0, 0.4, (n, d)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.6, (n, d)) * np.sqrt(omega)[None, :]
    if hot:
        D = np.asarray(pot_j.D)
        pi[5, 0] = np.sqrt(2.4 * D[0])          # dissociating
        pi[17, 1] = np.sqrt(1.9 * D[1] * 0.99)  # near the separatrix
        qi[9, 1] = np.nan                       # a poisoned row
    return qi, pi


@pytest.mark.parametrize("case", ["identity", "m0", "routed"])
def test_morse_map_matches_jax(case):
    """build / 25 x advance / materialise of both packages on one batch:
    from the identity, from an evolved M0 (three RK4 steps first: the map
    composes M0), and with routed rows (unbound, near-separatrix, NaN) on
    the RK4 side-channel."""
    pot, pot_j, q0, _, omega = _morse(d=5, seed=5)
    qi, pi = _morse_batch(pot_j, q0, omega, hot=case == "routed")
    state_j = JaxTrajState.initial(jnp.asarray(qi), jnp.asarray(pi),
                                   diag_monodromy=True)
    if case == "m0":
        for _ in range(3):
            state_j, _ = jax_eom.rk4_step(state_j, pot_j, 3.0)
    dt = 4.0
    pack_j, carry_j = jax_em.build_morse_map(state_j, pot_j, dt)
    pack, carry = em.build_morse_map(_port_state(state_j), pot, dt)
    assert (pack.m0 is not None) == pack_j.compose_m0 == (case == "m0")
    assert (pack.sub_idx is not None) == pack_j.has_sub == (case == "routed")
    if case == "routed":
        np.testing.assert_array_equal(pack.sub_idx.numpy(), [5, 9, 17])
    for _ in range(25):
        _, en_j = jax_em.morse_map_state(pack_j, carry_j, jnp.float64, pot_j)
        carry_j = jax_em.morse_map_advance(pack_j, carry_j, dt, pot_j)
        carry, en = em.morse_map_advance(pack, carry, dt, pot)
        _close(float(en), float(en_j), 1e-12, "energy")
    ref, _ = jax_em.morse_map_state(pack_j, carry_j, jnp.float64, pot_j)
    ref = jax_em.morse_map_merge(pack_j, carry_j, ref)
    _assert_state(em.morse_map_state(pack, carry), ref, 1e-12)


def test_harmonic_map_constants_match_jax():
    """T - I, w, T, the Van Loan action form and the center of both
    packages at a step spanning a zero mode and a saddle direction."""
    spectrum = np.array([0.015**2, 0.008**2, 0.004**2, 0.0, -0.006**2])
    pot, pot_j = _harmonic(d=5, seed=2, spectrum=spectrum)
    state_j = _dense_state(pot_j, n=4)
    ref = jax_eh.build_harmonic_map(pot_j, 20.0, state_j)
    got = eh.build_harmonic_map(pot, 20.0, _port_state(state_j))
    for name, ref_name in (("dT", "dT"), ("w", "w"), ("T", "T_mono"),
                           ("Wzz", "Wzz"), ("wz", "wz"), ("w11", "w11"),
                           ("pos0", "pos0")):
        g = getattr(got, name)
        _close(g.numpy() if torch.is_tensor(g) else g,
               np.asarray(getattr(ref, ref_name)), 1e-13, name)


def test_harmonic_step_matches_jax_on_methylium(ref_data):
    """20 exact steps of the methylium PES from the same displaced state:
    q, p, the monodromy blocks, S and the step energies at 1e-12."""
    pot, pot_j, _, _, _ = _methylium(ref_data)
    state_j = _dense_state(pot_j, n=16, seed=3)
    state = _port_state(state_j)
    hm_j = jax_eh.build_harmonic_map(pot_j, 4.0, state_j)
    hm = eh.build_harmonic_map(pot, 4.0, state)
    for _ in range(20):
        state_j, en_j = jax_eh.harmonic_step(hm_j, state_j, pot_j)
        state, en = eh.harmonic_step(hm, state, pot)
        _close(float(en), float(en_j), 1e-12, "energy")
    _assert_state(state, state_j, 1e-12)


# --- the propagators against the JAX package ------------------------------

def _as5(ref_data):
    model = ref_data / "AnharmonicAS" / "5modes" / "AS_model_chi0.02.dat"
    if not model.exists():
        pytest.skip(f"{model} not available")
    data = np.loadtxt(model)
    omega = data[:, 0] / units.hartree_to_wavenumbers
    S, nac, chi = data[:, 1], data[:, 2], data[:, 3]
    dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    return dict(G=np.diag(omega), q0=dQ, en0=float(np.sum(0.5 * omega)),
                pot=MorsePotential.create(omega, chi, nac, device="cpu"),
                pot_j=jax_potentials.MorsePotential.create(omega, chi, nac),
                dt=2.0, model=model)


def _pair(s, name, monkeypatch, hot=False):
    """Port and JAX propagators with integrator "exact" whose batches start
    from the same normals; `hot` injects an unbound and a near-separatrix
    row into both states (the side-channel)."""
    G, q0 = s["G"], s["q0"]
    sp = port_sampling.SamplingParams.create(q0, 0 * q0, G, G, "cpu")
    normals = np.random.default_rng(17).standard_normal((NTRAJ, 2 * sp.rank))
    args = (500.0, 500.0) if name == "WM" else ()
    prop = (WaltonManolopoulosPropagator if name == "WM"
            else HermanKlukPropagator)(G, G, *args, device="cpu",
                                       integrator="exact")
    prop.initial_conditions(q0, 0 * q0, G, s["pot"], ntraj=NTRAJ,
                            normals=torch.from_numpy(normals))
    sp_j = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, m: jnp.asarray(normals))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp_j, None,
                                                              NTRAJ)
    prop_j = (JaxWM if name == "WM" else JaxHK)(G, G, *args,
                                               integrator="exact")
    prop_j.initial_conditions(q0, 0 * q0, G, ntraj=NTRAJ, key=0,
                              potential=s["pot_j"])
    prop_j.state = JaxTrajState.initial(
        qi, pi, diag_monodromy=prop.state.diag_monodromy)
    make_bc = (jax_wm.wm_batch_constants if name == "WM"
               else jax_hk.hk_batch_constants)
    prop_j._bc = make_bc(prop_j.params, qi, pi, log_prob,
                         potential=s["pot_j"])
    prop_j.trackers = prop_j._make_trackers(prop_j.state)
    if hot:
        D = np.asarray(s["pot_j"].D)
        p = np.array(prop_j.state.p)
        p[3, 0] = np.sqrt(2.1 * D[0])
        p[40, 2] = np.sqrt(1.9 * D[2] * 0.95)
        prop_j.state = jax_replace(prop_j.state, p=jnp.asarray(p))
        prop.state = dataclasses.replace(prop.state, p=torch.from_numpy(p))
    return prop, prop_j


def _assert_stderr_close(got, ref, tol):
    """Within `tol` of the largest value, except where the variance is zero
    to rounding (both below 1e-6 of it)."""
    top = ref.max()
    live = ref > 1e-6 * top
    assert np.abs(got - ref)[live].max() <= tol * top
    assert (got[~live] <= 1e-6 * top).all()


PROP_CASES = [("as5", "HK", False), ("as5", "WM", False),
              ("as5", "HK", True), ("as5", "WM", True),
              ("methylium", "HK", False), ("methylium", "WM", False)]


@pytest.mark.parametrize("model, name, hot", PROP_CASES,
                         ids=[f"{m}-{n}" + ("-hot" if h else "")
                              for m, n, h in PROP_CASES])
def test_propagate_exact_matches_jax(ref_data, monkeypatch, model, name,
                                     hot):
    """propagate(error_bars=True) with integrator "exact" of both packages
    from the same draws, in two calls (the map's carry persists): C(t),
    k~ic(t) and their stderr at 1e-10 of their largest value."""
    if model == "as5":
        s = _as5(ref_data)
    else:
        pot, pot_j, q0, G, zpe = _methylium(ref_data)
        s = dict(G=G, q0=q0, en0=zpe, pot=pot, pot_j=pot_j, dt=4.0)
    prop, prop_j = _pair(s, name, monkeypatch, hot=hot)
    for nt in (NSTEPS // 2, NSTEPS // 2):
        got = prop.propagate(s["pot"], s["dt"], nt, energy0_es=s["en0"],
                             error_bars=True, check_energy=not hot)
        ref = prop_j.propagate(s["pot_j"], s["dt"], nt, energy0_es=s["en0"],
                               error_bars=True, check_energy=not hot)
        for g, r in zip(got[:2], ref[:2]):
            assert np.abs(g - r).max() <= 1e-10 * np.abs(r).max()
        for g, r in zip(got[2:], ref[2:]):
            _assert_stderr_close(g, r, 1e-10)
    if hot:
        assert prop._morse.pack.sub_idx.tolist() == [3, 40]


def test_exact_antithetic_error_bars_fall_back(ref_data, caplog):
    """With antithetic sampling and integrator "exact" the error bars take
    the i.i.d. formula and say so, as in the JAX package."""
    s = _as5(ref_data)

    def stderr(integrator):
        prop = HermanKlukPropagator(s["G"], s["G"], device="cpu",
                                    integrator=integrator)
        prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                                ntraj=128, sampling_method="antithetic",
                                generator=torch.Generator().manual_seed(2))
        if integrator == "rk4":
            prop.sampling_method = "pseudo"   # the i.i.d. formula
        return prop.propagate(s["pot"], 0.5, 10, error_bars=True)[2:]

    with caplog.at_level("WARNING"):
        exact = stderr("exact")
    assert "per-trajectory (conservative) stderr" in caplog.text
    for e, r in zip(exact, stderr("rk4")):
        np.testing.assert_allclose(e, r, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kind", ["as", "methylium"])
def test_cli_npz_matches_jax(ref_data, tmp_path, monkeypatch, kind):
    """`dynamics` + `rates` with integrator "exact" through both CLIs (two
    repetitions of 32 trajectories, 20 steps; WM on the 5-mode AS model,
    HK on methylium), the port handed the JAX CLI's draws: every npz key,
    type and shape alike, C(t) and k~ic(t) at 1e-10, the rate at 1e-8."""
    if kind == "as":
        potential = {"type": "anharmonic AS",
                     "model_file": str(_as5(ref_data)["model"])}
        extra = {"propagator": "WM", "cell_width": 1e4,
                 "time_step_fs": 0.05}
    else:
        _methylium(ref_data)
        base = ref_data / "examples" / "methylium_AH"
        potential = {"type": "harmonic",
                     "ground": str(base / "opt_freq_s0.fchk"),
                     "excited": str(base / "opt_freq_s1.fchk"),
                     "coupling": str(base / "opt_freq_s1.fchk")}
        extra = {"propagator": "HK", "time_step_fs": 0.1}
    task = {"task": "dynamics", "potential": potential, "batch_size": 32,
            "num_trajectories": 64, "num_steps": NSTEPS, "manual_seed": 3,
            "integrator": "exact", **extra,
            "results": {"correlations": str(tmp_path / "port.npz")}}
    rates = {"task": "rates", "broadening": "gaussian", "hwhmG_ev": 0.01}
    jnpz = str(tmp_path / "j.npz")
    jax_cli.run_semiclassical_dynamics(
        dict(task, results={"correlations": jnpz}), num_devices=1,
        precision="f64")
    jax_cli.calculate_rates(dict(rates, correlations=jnpz, rates=jnpz))

    draws = iter(jax.random.split(jax.random.key(3), 2))
    monkeypatch.setattr(
        port_sampling, "_gaussian",
        lambda shape, generator, dtype, device: torch.tensor(np.asarray(
            jax.random.normal(next(draws), shape, dtype=jnp.float64))))
    npz = task["results"]["correlations"]
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [
        task, dict(rates, correlations=npz, rates=npz)]}))
    assert cli.main(["dynamics", str(path), "--device", "cpu"]) == 0
    assert cli.main(["rates", str(path)]) == 0
    got, ref = dict(np.load(npz)), dict(np.load(jnpz))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and \
            got[key].dtype == ref[key].dtype, key
    for key, tol in (("autocorrelation", 1e-10), ("ic_correlation", 1e-10),
                     ("ic_rate", 1e-8)):
        assert np.abs(got[key] - ref[key]).max() <= tol * np.abs(
            ref[key]).max(), key


# --- twins of tests/test_exact_morse.py -----------------------------------

def _state(qi, pi):
    return TrajState.initial(torch.from_numpy(qi), torch.from_numpy(pi),
                             diag_monodromy=True)


def _hk(G, q0, pot, integrator="exact", ntraj=128, seed=3, cls=None,
        args=()):
    prop = (cls or HermanKlukPropagator)(G, G, *args, device="cpu",
                                         integrator=integrator)
    prop.initial_conditions(q0, np.zeros(q0.size), G, pot, ntraj=ntraj,
                            generator=torch.Generator().manual_seed(seed))
    return prop


def test_map_matches_tiny_step_rk4():
    """The map against the port's RK4 at a 64x smaller step: below 1e-9."""
    pot, pot_j, q0c, _, omega = _morse(d=4, seed=5)
    rng = np.random.default_rng(7)
    qi = q0c[None, :] + rng.normal(0, 0.4, (16, 4)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.6, (16, 4)) * np.sqrt(omega)[None, :]
    state = _state(qi, pi)
    dt, nt, sub = 4.0, 25, 64
    pack, carry = em.build_morse_map(state, pot, dt)
    for _ in range(nt):
        carry, _ = em.morse_map_advance(pack, carry, dt, pot)
    exact = em.morse_map_state(pack, carry)
    ref = state
    for _ in range(nt * sub):
        ref, _ = rk4_step(ref, pot, dt / sub)
    sq = np.sqrt(omega)[None, :]
    assert (np.abs((exact.q - ref.q).numpy()) * sq).max() < 1e-9
    assert (np.abs((exact.p - ref.p).numpy()) / sq).max() < 1e-9
    for blk in ("Mqq", "Mqp", "Mpq", "Mpp"):
        a, b = getattr(exact, blk).numpy(), getattr(ref, blk).numpy()
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-9, blk
    assert np.abs((exact.S - ref.S).numpy()).max() < 1e-9


@pytest.mark.parametrize("name", ["HK", "WM"])
def test_exact_matches_rk4_correlation(name):
    """Twin runs from the same draws: the exact map reproduces the small-dt
    RK4 C(t) and k~ic(t) to RK4's own truncation error (< 1e-6)."""
    pot, _, q0, G, _ = _morse(d=6 if name == "HK" else 5,
                              seed=1 if name == "HK" else 11)
    args = (200.0, 200.0) if name == "WM" else ()
    cls = WaltonManolopoulosPropagator if name == "WM" else None
    nt = 80 if name == "HK" else 60
    c_rk4, k_rk4 = _hk(G, q0, pot, "rk4", 512, 3, cls, args).propagate(
        pot, 1.0, nt)
    c_ex, k_ex = _hk(G, q0, pot, "exact", 512, 3, cls, args).propagate(
        pot, 1.0, nt)
    assert np.abs(c_ex - c_rk4).max() < 1e-6
    assert np.abs(k_ex - k_rk4).max() / np.abs(k_rk4).max() < 1e-6


def test_exact_large_dt_consistent():
    """A 16x larger step samples the same C(t) at the shared times (1e-9)."""
    pot, _, q0, G, _ = _morse(d=4, seed=2)
    fine = _hk(G, q0, pot, ntraj=256, seed=9).propagate(pot, 1.0, 64)[0]
    coarse = _hk(G, q0, pot, ntraj=256, seed=9).propagate(pot, 16.0, 4)[0]
    np.testing.assert_allclose(coarse, fine[::16], rtol=0, atol=1e-9)


def test_exact_chunked_scan_equivalence():
    """The carried phase persists across segments and calls: chunked runs
    and a run split over two calls reproduce the single run bit for bit."""
    pot, _, q0, G, _ = _morse(d=5, seed=3)

    def run(chunk):
        return _hk(G, q0, pot, seed=1).propagate(pot, 2.0, 30,
                                                 chunk=chunk)[0]

    single = run(None)
    np.testing.assert_array_equal(run(7), single)
    prop = _hk(G, q0, pot, seed=1)
    split = np.concatenate([prop.propagate(pot, 2.0, 11)[0],
                            prop.propagate(pot, 2.0, 19)[0]])
    np.testing.assert_allclose(split, single, rtol=0, atol=1e-15)


def test_exact_energy_is_constant():
    """The map conserves energy exactly: the per-step energies are one
    constant."""
    pot, _, q0, G, _ = _morse(d=4, seed=8)
    prop = _hk(G, q0, pot, ntraj=64, seed=2)
    prop.propagate(pot, 2.0, 20, check_energy=True)
    assert np.ptp(prop.last_energies) == 0.0


def test_exact_unbound_rows_take_rk4_side_channel():
    """Unbound rows ride RK4 inside the hybrid map: the whole state matches
    an 8x finer RK4 run, and the dissociating row flies outward."""
    pot, pot_j, q0, _, omega = _morse(d=3, seed=12)
    rng = np.random.default_rng(0)
    qi = q0[None, :] + rng.normal(0, 0.3, (64, 3)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.5, (64, 3)) * np.sqrt(omega)[None, :]
    D = pot.D.numpy()
    pi[5, 0] = np.sqrt(2.4 * D[0])
    pi[17, 1] = np.sqrt(1.9 * D[1] * 0.99)
    state = _state(qi, pi)
    pack, carry = em.build_morse_map(state, pot, 1.0)
    assert carry.sub is not None
    ref = state
    for _ in range(40):
        carry, en = em.morse_map_advance(pack, carry, 1.0, pot)
        for _ in range(8):
            ref, _ = rk4_step(ref, pot, 1.0 / 8)
    st = em.morse_map_state(pack, carry)
    assert float(st.q[5, 0]) > float(qi[5, 0])
    np.testing.assert_allclose(st.q.numpy(), ref.q.numpy(), rtol=0,
                               atol=2e-4 * float(ref.q.abs().max()))
    assert np.isfinite(st.S.numpy()).all() and np.isfinite(float(en))


def test_exact_propagate_with_unbound_rows_matches_rk4():
    """propagate on a batch with injected hot rows matches the pure RK4
    run (both step those rows by RK4), and a chunked run the single one."""
    pot, _, q0, G, _ = _morse(d=4, seed=14)
    D = pot.D.numpy()

    def run(integrator, chunk=None):
        prop = _hk(G, q0, pot, integrator, 256, 8)
        p = prop.state.p.clone()
        p[3, 0] = np.sqrt(2.1 * D[0])
        p[100, 2] = np.sqrt(1.9 * D[2] * 0.95)
        prop.state = dataclasses.replace(prop.state, p=p)
        return prop.propagate(pot, 1.0, 30, check_energy=False, chunk=chunk)

    c_rk4, k_rk4 = run("rk4")
    c_ex, k_ex = run("exact")
    assert np.abs(c_ex - c_rk4).max() < 1e-6
    assert np.abs(k_ex - k_rk4).max() / np.abs(k_rk4).max() < 1e-6
    np.testing.assert_allclose(run("exact", chunk=7)[0], c_ex, rtol=0,
                               atol=1e-12)


def test_exact_too_hot_ensemble_raises():
    pot, _, _, _, _ = _morse(d=3, seed=13)
    pi = np.sqrt(2.5 * pot.D.numpy())[None, :] * np.ones((16, 3))
    with pytest.raises(ValueError, match="too hot"):
        em.build_morse_map(_state(np.zeros((16, 3)), pi), pot, 1.0)


def test_exact_nan_rows_are_routed_not_rest_stated():
    """A NaN row is routed to the side-channel (not replaced by a rest
    state), where the NaN reaches the energies and the guard."""
    pot, _, q0, _, omega = _morse(d=3, seed=21)
    rng = np.random.default_rng(1)
    qi = q0[None, :] + rng.normal(0, 0.2, (64, 3)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.4, (64, 3)) * np.sqrt(omega)[None, :]
    qi[9, 1] = np.nan
    pack, carry = em.build_morse_map(_state(qi, pi), pot, 1.0)
    assert pack.sub_idx.tolist() == [9]
    _, en = em.morse_map_advance(pack, carry, 1.0, pot)
    assert not np.isfinite(float(en))


def test_exact_step_then_propagate_matches_jax_deferred(monkeypatch):
    """`step` builds the map and `propagate` continues it: the result
    equals the JAX package's run whose batch constants were deferred to
    `propagate` (its k~ic(t) is non-zero there only with the refresh)."""
    pot, pot_j, q0, G, _ = _morse(d=4, seed=22)
    n = 128
    normals = np.random.default_rng(4).standard_normal((n, 8))
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, m: jnp.asarray(normals))
    prop_j = JaxHK(G, G, integrator="exact")
    prop_j.initial_conditions(q0, np.zeros(4), G, ntraj=n, key=3,
                              potential=None)
    prop_j.state = JaxTrajState.initial(prop_j.state.q, prop_j.state.p,
                                        diag_monodromy=True)
    prop_j.step(pot_j, 1.0)
    c_j, k_j = prop_j.propagate(pot_j, 1.0, 20)

    prop = HermanKlukPropagator(G, G, device="cpu", integrator="exact")
    prop.initial_conditions(q0, np.zeros(4), G, pot, ntraj=n,
                            normals=torch.from_numpy(normals))
    prop.step(pot, 1.0)
    c, k = prop.propagate(pot, 1.0, 20)
    assert np.abs(k_j).max() > 0
    np.testing.assert_allclose(k, k_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(c, c_j, rtol=0, atol=1e-12)


def test_exact_requires_morse():
    pot = NonHarmonicPotential.create(dim=3, device="cpu")
    G = np.eye(3)
    prop = HermanKlukPropagator(G, G, device="cpu", integrator="exact")
    prop.initial_conditions(np.full(3, 0.2), np.zeros(3), G, pot, ntraj=32,
                            generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="MorsePotential"):
        prop.propagate(pot, 1.0, 2)


@pytest.mark.parametrize("cls", [HermanKlukPropagator,
                                 WaltonManolopoulosPropagator])
def test_exact_invalid_integrator_name(cls):
    args = (1.0, 1.0) if cls is WaltonManolopoulosPropagator else ()
    with pytest.raises(ValueError, match="integrator"):
        cls(np.eye(2), np.eye(2), *args, device="cpu", integrator="leapfrog")


def test_exact_state_surgery_rebuilds_map():
    """A state assigned from outside rebuilds the map: the continuation
    tracks RK4 on the same surged state."""
    pot, _, q0, G, _ = _morse(d=4, seed=8)

    def run(integrator):
        prop = _hk(G, q0, pot, integrator, seed=5)
        prop.propagate(pot, 1.0, 10)
        prop.state = dataclasses.replace(prop.state, p=1.2 * prop.state.p)
        return prop.propagate(pot, 1.0, 20)[0]

    assert np.abs(run("exact") - run("rk4")).max() < 1e-6


def test_exact_wdt_reduced_mod_2pi_any_dt():
    """The phase increment is reduced mod 2 pi: a step of several periods
    samples the orbit of 64x finer steps (1e-8)."""
    pot, _, q0c, _, omega = _morse(d=4, seed=6)
    rng = np.random.default_rng(3)
    qi = q0c[None, :] + rng.normal(0, 0.3, (32, 4)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.5, (32, 4)) * np.sqrt(omega)[None, :]
    state = _state(qi, pi)
    dt = float(3.0 * np.pi / omega.min())
    packc, carryc = em.build_morse_map(state, pot, dt)
    assert packc.wdt_hi.abs().max() <= np.pi + 1e-12
    assert not packc.wdt_lo.any()      # float64: no lo part
    packf, carryf = em.build_morse_map(state, pot, dt / 64)
    for _ in range(4):
        carryc, _ = em.morse_map_advance(packc, carryc, dt, pot)
    for _ in range(4 * 64):
        carryf, _ = em.morse_map_advance(packf, carryf, dt / 64, pot)
    coarse = em.morse_map_state(packc, carryc)
    fine = em.morse_map_state(packf, carryf)
    for blk in ("q", "p", "S", "Mqq", "Mqp", "Mpq", "Mpp"):
        a, b = getattr(coarse, blk).numpy(), getattr(fine, blk).numpy()
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-8, blk


def test_exact_micro_batch_is_ignored(caplog):
    """micro_batch gives way to the exact map (a log line says so): the
    result is the whole batch's, bit for bit."""
    pot, _, q0, G, _ = _morse(d=4, seed=8)
    whole = _hk(G, q0, pot, seed=5).propagate(pot, 1.0, 10)[0]
    prop = _hk(G, q0, pot, seed=5)
    with caplog.at_level("INFO"):
        micro = prop.propagate(pot, 1.0, 10, micro_batch=32)[0]
    assert "micro_batch=32 is ignored" in caplog.text
    np.testing.assert_array_equal(micro, whole)


# --- twins of tests/test_exact_harmonic.py --------------------------------

def _port_dense(pot_j, n, seed):
    return _port_state(_dense_state(pot_j, n=n, seed=seed))


def test_supports_detection():
    pot, _ = _harmonic()
    assert eh.supports_exact_harmonic(pot)
    morse = MorsePotential.create(np.array([0.01]), np.array([0.02]),
                                  np.array([0.5]), device="cpu")
    assert not eh.supports_exact_harmonic(morse)
    assert em.supports_exact_morse(
        morse, _state(np.zeros((2, 1)), np.zeros((2, 1))))


def test_rk4_converges_to_exact_map():
    """One exact step of DT equals 256 RK4 steps of DT/256 (a zero mode and
    a saddle direction included)."""
    spectrum = np.array([0.015**2, 0.008**2, 0.004**2, 0.0, -0.006**2])
    pot, pot_j = _harmonic(d=5, seed=2, spectrum=spectrum)
    state = _port_dense(pot_j, 8, 3)
    exact, _ = eh.harmonic_step(eh.build_harmonic_map(pot, 20.0, state),
                                state, pot)
    fine = state
    for _ in range(256):
        fine, _ = rk4_step(fine, pot, 20.0 / 256)
    np.testing.assert_allclose(exact.q.numpy(), fine.q.numpy(), rtol=1e-10,
                               atol=1e-11)
    np.testing.assert_allclose(exact.p.numpy(), fine.p.numpy(), rtol=1e-10,
                               atol=1e-11)
    np.testing.assert_allclose(exact.S.numpy(), fine.S.numpy(), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(exact.Z.numpy(), fine.Z.numpy(), rtol=1e-8,
                               atol=1e-9)


def test_monodromy_stays_symplectic():
    """Mqq^T Mpp - Mpq^T Mqp = 1 after 200 coarse steps."""
    pot, pot_j = _harmonic(d=4, seed=4)
    state = _port_dense(pot_j, 4, 5)
    hmap = eh.build_harmonic_map(pot, 50.0, state)
    for _ in range(200):
        state, _ = eh.harmonic_step(hmap, state, pot)
    Mqq, Mqp = state.Mqq.numpy(), state.Mqp.numpy()
    Mpq, Mpp = state.Mpq.numpy(), state.Mpp.numpy()
    for i in range(Mqq.shape[0]):
        np.testing.assert_allclose(Mqq[i].T @ Mpp[i] - Mpq[i].T @ Mqp[i],
                                   np.eye(4), rtol=1e-10, atol=1e-10)


def test_energy_exactly_conserved():
    pot, pot_j = _harmonic(d=4, seed=6)
    state = _port_dense(pot_j, 16, 7)
    hmap = eh.build_harmonic_map(pot, 100.0, state)
    energies = []
    for _ in range(50):
        state, en = eh.harmonic_step(hmap, state, pot)
        energies.append(float(en))
    energies = np.asarray(energies)
    assert np.abs(np.diff(energies)).max() < 1e-10 * max(
        1.0, np.abs(energies).max())


def _run_harmonic(pot, integrator, dt, nt, ntraj=64, seed=11):
    G = np.diag(np.sqrt(pot.mass.numpy())
                * np.linalg.eigvalsh(pot.hess0.numpy()).max() ** 0.5)
    q0 = pot.pos0.numpy() + 0.05
    prop = HermanKlukPropagator(G, G, device="cpu", integrator=integrator)
    prop.initial_conditions(q0, np.zeros(q0.size), G, pot, ntraj=ntraj,
                            generator=torch.Generator().manual_seed(seed))
    cauto, kic = prop.propagate(pot, dt, nt, energy0_es=0.1)
    return prop.state, cauto, kic


def test_hk_twin_gap_vs_rk4():
    """The exact - RK4 gap is RK4's 4th-order error: below 1e-6 and ~16x
    smaller at half the step."""
    pot, _ = _harmonic(d=4, seed=8)

    def gap(dt, nt):
        s_rk4, c_rk4, _ = _run_harmonic(pot, "rk4", dt, nt)
        s_ex, c_ex, _ = _run_harmonic(pot, "exact", dt, nt)
        return (np.abs((s_ex.q - s_rk4.q).numpy()).max(),
                np.abs(c_ex - c_rk4).max(), c_rk4)

    gq_c, gc_c, c_rk4 = gap(2.0, 50)
    gq_f, _, _ = gap(1.0, 100)
    assert gq_c < 1e-6 and gc_c < 1e-6
    assert gq_c / gq_f > 10.0
    assert np.abs(c_rk4[-1] - c_rk4[0]) > 1e-4


def test_exact_at_coarse_dt():
    """C(t) on a 16x coarser grid equals the fine grid's at the shared
    times to 5e-12."""
    pot, _ = _harmonic(d=4, seed=9)
    _, c_fine, _ = _run_harmonic(pot, "exact", 2.0, 64)
    _, c_coarse, _ = _run_harmonic(pot, "exact", 32.0, 4)
    np.testing.assert_allclose(c_coarse, c_fine[::16][:4], rtol=0,
                               atol=5e-12)


def test_hmap_rebuilds_for_new_potential_object():
    """A new potential object through the same propagator (same dt)
    rebuilds the map."""
    pot_a, _ = _harmonic(d=4, seed=20)
    pot_b = dataclasses.replace(pot_a, hess0=1.3 * pot_a.hess0)
    G = np.diag(np.sqrt(pot_a.mass.numpy())
                * np.linalg.eigvalsh(pot_a.hess0.numpy()).max() ** 0.5)
    q0 = pot_a.pos0.numpy() + 0.05

    def init(prop, pot):
        prop.initial_conditions(q0, np.zeros(4), G, pot, ntraj=16,
                                generator=torch.Generator().manual_seed(3))

    prop = HermanKlukPropagator(G, G, device="cpu", integrator="exact")
    init(prop, pot_a)
    prop.propagate(pot_a, 2.0, 8, energy0_es=0.1)
    q_a = prop.state.q.numpy()
    init(prop, pot_b)
    prop.propagate(pot_b, 2.0, 8, energy0_es=0.1)
    q_b_cached = prop.state.q.numpy()
    prop2 = HermanKlukPropagator(G, G, device="cpu", integrator="exact")
    init(prop2, pot_b)
    prop2.propagate(pot_b, 2.0, 8, energy0_es=0.1)
    np.testing.assert_allclose(q_b_cached, prop2.state.q.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert np.abs(prop2.state.q.numpy() - q_a).max() > 1e-6


def test_cli_integrator_exact_molecular(ref_data, tmp_path):
    """`integrator: "exact"` on methylium through the port's CLI agrees
    with the RK4 run at production steps (same seed) to 1e-9."""
    _methylium(ref_data)
    base = ref_data / "examples" / "methylium_AH"

    def task(integrator, out):
        return {"task": "dynamics",
                "potential": {"type": "harmonic",
                              "ground": str(base / "opt_freq_s0.fchk"),
                              "excited": str(base / "opt_freq_s1.fchk"),
                              "coupling": str(base / "opt_freq_s1.fchk")},
                "propagator": "HK", "integrator": integrator,
                "batch_size": 32, "num_trajectories": 32, "num_steps": 16,
                "time_step_fs": 0.005, "manual_seed": 0,
                "results": {"correlations": str(tmp_path / out)}}

    cli.run_semiclassical_dynamics(task("rk4", "rk4.npz"), device="cpu")
    cli.run_semiclassical_dynamics(task("exact", "exact.npz"), device="cpu")
    d_rk4 = np.load(tmp_path / "rk4.npz")
    d_ex = np.load(tmp_path / "exact.npz")
    for key in ("autocorrelation", "ic_correlation"):
        np.testing.assert_allclose(d_ex[key], d_rk4[key], rtol=0, atol=1e-9)
