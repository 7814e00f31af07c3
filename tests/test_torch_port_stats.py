# coding: utf-8
"""The port's Monte-Carlo statistics against the JAX package at float64 on
the CPU: the antithetic and sobol draws and the sampling statistics, the
per-step standard errors of C(t) and k~ic(t) (HK and WM, dense and
separable, pseudo and antithetic), `micro_batch`, the error bands of the
rate and the spectrum, and the CLI's `dynamics` + `rates` + `spectrum`
with `error_bars` under every `sampling`; then the variance reductions of
tests/test_sampling_vr.py at its scale.

Inputs are made with numpy (or drawn by `jax.random` and handed to both
packages) and go into both; tolerances: sobol points bit for bit, the
sampling statistics at 1e-5 (the JAX package's covariance product is
float32), the per-step stderr at 1e-10 relative to its largest value,
C(t) and k~ic(t) at 1e-8, micro-batched sums at 1e-12, the Fourier
transforms and their bands at 1e-12 relative, the CLI npz at 1e-8 (the
rate and spectrum at 1e-6).
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
from semiclassical_tpu.analysis import rates as jax_rates
from semiclassical_tpu.analysis.broadening import gaussian as jax_gaussian
from semiclassical_tpu.analysis.broadening import \
    lorentzian as jax_lorentzian
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch import sampling as port_sampling
from semiclassical_tpu_torch.analysis import (fourier_stderr, gaussian,
                                              lorentzian,
                                              spectrum_from_correlation)
from semiclassical_tpu_torch.config import ConfigurationError
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                MorsePotential, minimize)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator)

NTRAJ = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
NSTEPS = 12


def _sampling_params(d=4, seed=0):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(0.002, 0.01, size=d)
    q0 = rng.uniform(-0.5, 0.5, size=d)
    p0 = rng.uniform(-0.1, 0.1, size=d)
    G = np.diag(omega)
    return (port_sampling.SamplingParams.create(q0, p0, G, G, "cpu"),
            jax_sampling.SamplingParams.create(q0, p0, G, G))


# --- the draws and the sampling statistics -------------------------------

def test_antithetic_structure_and_density():
    params, _ = _sampling_params()
    gen = torch.Generator().manual_seed(1)
    q, p, logp = port_sampling.sample_initial_conditions(
        params, 64, normals=port_sampling.standard_normals(
            params, 64, "antithetic", gen))
    z = torch.cat([q, p], dim=1).numpy()
    z0 = params.z0.numpy()
    # interleaved pairs mirror exactly around the center, with one density
    assert np.allclose(z[0::2] + z[1::2], 2.0 * z0[None, :], atol=1e-12)
    assert np.allclose(logp[0::2].numpy(), logp[1::2].numpy(), atol=1e-12)
    mean_dev, _ = port_sampling.sampling_statistics(params, q, p)
    assert mean_dev < 1e-10


@pytest.mark.parametrize("ntraj, method, match", [
    (63, "antithetic", "even"), (64, "qmc", "unknown sampling method")])
def test_bad_draws_raise(ntraj, method, match):
    params, _ = _sampling_params()
    with pytest.raises(ValueError, match=match):
        port_sampling.standard_normals(params, ntraj, method,
                                       torch.Generator().manual_seed(0))


@pytest.mark.parametrize("ntraj", [256, 100], ids=["pow2", "not_pow2"])
def test_sobol_points_equal_jax(ntraj, caplog):
    """The same scramble seed gives the JAX package's points bit for bit;
    the JAX package draws the seed from its key, the port from its
    generator (or takes it explicitly)."""
    params, params_j = _sampling_params()
    key = jax.random.key(11)
    seed = int(jax.random.randint(key, (), 0, np.int32(2**31 - 1)))
    ref = np.asarray(jax_sampling._standard_normals(params_j, key, ntraj,
                                                    "sobol"))
    with caplog.at_level("WARNING", logger=port_sampling.logger.name):
        got = port_sampling.standard_normals(params, ntraj, "sobol",
                                             seed=seed).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ("non-power-of-two" in caplog.text) == (ntraj == 100)
    # from a generator: a seed in [0, 2^31 - 1), reproducible
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    np.testing.assert_array_equal(
        port_sampling.standard_normals(params, ntraj, "sobol", g1).numpy(),
        port_sampling.standard_normals(params, ntraj, "sobol", g2).numpy())


@pytest.mark.parametrize("method", ["pseudo", "antithetic", "sobol"])
def test_sampling_statistics_match_jax(method):
    params, params_j = _sampling_params(d=5, seed=2)
    gen = torch.Generator().manual_seed(3)
    q, p, _ = port_sampling.sample_initial_conditions(
        params, 2048,
        normals=port_sampling.standard_normals(params, 2048, method, gen))
    got = port_sampling.sampling_statistics(params, q, p)
    ref = jax_sampling.sampling_statistics(params_j, jnp.asarray(q.numpy()),
                                           jnp.asarray(p.numpy()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got[1] < 3.0 * np.sqrt(2.0 / 2048)


def test_initial_conditions_log_sampling_statistics(caplog):
    omega = np.array([0.004, 0.006, 0.009])
    G = np.diag(omega)
    pot = MorsePotential.create(omega, np.full(3, 0.02), np.ones(3),
                                device="cpu")
    prop = HermanKlukPropagator(G, G, device="cpu")
    with caplog.at_level("INFO", logger=port_sampling.logger.name):
        prop.initial_conditions(np.full(3, 0.2), np.zeros(3), G, pot,
                                ntraj=128,
                                generator=torch.Generator().manual_seed(0))
    lines = [r.getMessage() for r in caplog.records
             if r.name == port_sampling.logger.name]
    assert [line.split(":")[0].strip() for line in lines] == [
        "max |<z> - z0| / sigma", "max |cov(z) - analytic| / sigma2"]


# --- per-step standard errors against the JAX package ---------------------

def _as5(ref_data):
    model = ref_data / "AnharmonicAS" / "5modes" / "AS_model_chi0.02.dat"
    if not model.exists():
        pytest.skip(f"{model} not available")
    data = np.loadtxt(model)
    omega = data[:, 0] / units.hartree_to_wavenumbers
    S, nac, chi = data[:, 1], data[:, 2], data[:, 3]
    dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    G = np.diag(omega)
    return dict(G=G, q0=dQ, en0=float(np.sum(0.5 * omega)),
                pot=MorsePotential.create(omega, chi, nac, device="cpu"),
                pot_j=jax_potentials.MorsePotential.create(omega, chi, nac),
                dt=150.0 / units.autime_to_fs / 40.0 / 99, model=model)


def _methylium(ref_data):
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
    return dict(G=G0, q0=x0, en0=zpe, pot=pot, pot_j=pot_j, dt=4.0)


def _draw(rank, method, seed=17):
    """(NTRAJ, 2 rank) normals, +-pairs interleaved for "antithetic"."""
    rng = np.random.default_rng(seed)
    if method == "antithetic":
        half = rng.standard_normal((NTRAJ // 2, 2 * rank))
        return np.stack([half, -half], axis=1).reshape(NTRAJ, 2 * rank)
    return rng.standard_normal((NTRAJ, 2 * rank))


def _pair(s, name, method, monkeypatch):
    """A port and a JAX propagator (HK, or WM at cell width 500) whose
    batches start from the same normals."""
    G, q0 = s["G"], s["q0"]
    sp = port_sampling.SamplingParams.create(q0, 0 * q0, G, G, "cpu")
    normals = _draw(sp.rank, method)
    args = (500.0, 500.0) if name == "WM" else ()
    prop = (WaltonManolopoulosPropagator if name == "WM"
            else HermanKlukPropagator)(G, G, *args, device="cpu")
    prop.initial_conditions(q0, 0 * q0, G, s["pot"], ntraj=NTRAJ,
                            normals=torch.from_numpy(normals),
                            sampling_method=method)

    sp_j = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, m: jnp.asarray(normals))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp_j, None,
                                                              NTRAJ)
    prop_j = (JaxWM if name == "WM" else JaxHK)(G, G, *args)
    prop_j.initial_conditions(q0, 0 * q0, G, ntraj=NTRAJ, key=0,
                              potential=s["pot_j"], sampling_method=method)
    prop_j.state = JaxTrajState.initial(qi, pi,
                                        diag_monodromy=prop.state.diag_monodromy)
    make_bc = (jax_wm.wm_batch_constants if name == "WM"
               else jax_hk.hk_batch_constants)
    prop_j._bc = make_bc(prop_j.params, qi, pi, log_prob,
                         potential=s["pot_j"])
    prop_j.trackers = prop_j._make_trackers(prop_j.state)
    return prop, prop_j


STDERR_CASES = [("as5", "HK", "pseudo"), ("as5", "HK", "antithetic"),
                ("as5", "WM", "pseudo"), ("as5", "WM", "antithetic"),
                ("methylium", "HK", "pseudo"), ("methylium", "WM", "pseudo"),
                ("methylium", "WM", "antithetic")]


@pytest.mark.parametrize("model, name, method", STDERR_CASES,
                         ids=["-".join(c) for c in STDERR_CASES])
def test_stderr_matches_jax(ref_data, monkeypatch, model, name, method):
    """propagate(error_bars=True) of both packages from the same draws:
    C(t), k~ic(t) at 1e-8 and both per-step standard errors at 1e-10 of
    their largest value (the antithetic runs fold the +-pairs)."""
    s = _as5(ref_data) if model == "as5" else _methylium(ref_data)
    prop, prop_j = _pair(s, name, method, monkeypatch)
    got = prop.propagate(s["pot"], s["dt"], NSTEPS, energy0_es=s["en0"],
                         error_bars=True)
    ref = prop_j.propagate(s["pot_j"], s["dt"], NSTEPS, energy0_es=s["en0"],
                           error_bars=True)
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == r.shape == (NSTEPS,)
        assert np.abs(g - r).max() <= 1e-8 * np.abs(r).max()
    for g, r in zip(got[2:], ref[2:]):
        _assert_stderr_close(g, r, 1e-10)
    assert (got[2][1:] > 0).all() and (got[3] > 0).all()


def _assert_stderr_close(got, ref, tol):
    """Within `tol` of the largest value, except where the variance is
    zero to rounding (the HK C(t) at t = 0: importance sampling makes
    every contribution 1/n), where both are below 1e-6 of it: there the
    square root lifts the rounding of sum |x|^2 - |sum x|^2 / n."""
    top = ref.max()
    live = ref > 1e-6 * top
    assert np.abs(got - ref)[live].max() <= tol * top
    assert (got[~live] <= 1e-6 * top).all()


def test_stderr_is_direct_per_trajectory_formula(ref_data):
    """At a propagated state the stderr is sqrt(sum |x|^2 - |sum x|^2 / n)
    of the weighted per-trajectory contributions of the granular API."""
    from semiclassical_tpu_torch.propagation.hk import hk_autocorr_qp

    s = _as5(ref_data)

    def fresh():
        prop = HermanKlukPropagator(s["G"], s["G"], device="cpu")
        prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                                ntraj=512,
                                generator=torch.Generator().manual_seed(4))
        prop.propagate(s["pot"], s["dt"], 5)
        return prop

    prop = fresh()
    _, _, ec, _ = prop.propagate(s["pot"], s["dt"], 1, error_bars=True)
    twin = fresh()
    x = hk_autocorr_qp(twin.params, twin.bc, twin.state,
                       twin.semiclassical_prefactor()).numpy()
    x = x * twin.bc.weight_scale
    direct = np.sqrt((np.abs(x) ** 2).sum() - abs(x.sum()) ** 2 / x.size)
    assert abs(direct - ec[0]) < 1e-10 * direct


def test_antithetic_error_bars_fold_pairs(ref_data):
    """The pair-folded stderr is smaller than the i.i.d. formula's on C(t)
    (the members anticorrelate) and larger on k~ic (they correlate), on
    one ensemble — the i.i.d. formula would misreport both."""
    s = _as5(ref_data)

    def stderr(method_label):
        prop = HermanKlukPropagator(s["G"], s["G"], device="cpu")
        prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                                ntraj=512,
                                generator=torch.Generator().manual_seed(7),
                                sampling_method="antithetic")
        prop.sampling_method = method_label
        return prop.propagate(s["pot"], s["dt"], 8, error_bars=True)[2:]

    pair_c, pair_k = stderr("antithetic")
    iid_c, iid_k = stderr("pseudo")
    assert pair_c[0] < 1e-8
    assert (pair_c[1:] < iid_c[1:]).all()
    assert (pair_k > iid_k).all()


# --- micro_batch -----------------------------------------------------------

MICRO_CASES = [("as5", "HK", "pseudo"), ("as5", "WM", "antithetic"),
               ("methylium", "WM", "pseudo")]


@pytest.mark.parametrize("error_bars", [False, True],
                         ids=["plain", "error_bars"])
@pytest.mark.parametrize("model, name, method", MICRO_CASES,
                         ids=["-".join(c) for c in MICRO_CASES])
def test_micro_batch_equals_whole_batch(ref_data, model, name, method,
                                        error_bars):
    """Sub-batches of 16 against the whole batch of 64 in segments of 5
    steps: C(t) and k~ic(t) within 1e-12 of their largest value, the
    stderr within 1e-10 (the JAX package's own micro-batch gate: the
    difference sum |x|^2 - |sum x|^2 / n amplifies the re-associated
    sums' rounding), the state and the trackers identical."""
    s = _as5(ref_data) if model == "as5" else _methylium(ref_data)
    args = (500.0, 500.0) if name == "WM" else ()
    cls = WaltonManolopoulosPropagator if name == "WM" else HermanKlukPropagator
    sp = port_sampling.SamplingParams.create(s["q0"], 0 * s["q0"], s["G"],
                                             s["G"], "cpu")
    normals = torch.from_numpy(_draw(sp.rank, method, seed=3))
    runs = []
    for micro in (0, 16):
        prop = cls(s["G"], s["G"], *args, device="cpu")
        prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                                ntraj=NTRAJ, normals=normals,
                                sampling_method=method)
        out = prop.propagate(s["pot"], s["dt"], NSTEPS, energy0_es=s["en0"],
                             chunk=5, error_bars=error_bars,
                             micro_batch=micro)
        runs.append((prop, out))
    (whole, ref), (micro, got) = runs
    assert len(got) == (4 if error_bars else 2)
    for g, r, tol in zip(got, ref, (1e-12, 1e-12, 1e-10, 1e-10)):
        assert np.abs(g - r).max() <= tol * np.abs(r).max()
    for field in ("q", "p", "Z", "S"):
        torch.testing.assert_close(getattr(micro.state, field),
                                   getattr(whole.state, field), rtol=1e-14,
                                   atol=1e-14)
    trackers = ([micro.tracker] if name == "HK" else
                [getattr(micro.tracker, f.name)
                 for f in dataclasses.fields(micro.tracker)])
    refs = ([whole.tracker] if name == "HK" else
            [getattr(whole.tracker, f.name)
             for f in dataclasses.fields(whole.tracker)])
    for a, b in zip(trackers, refs):
        assert torch.equal(a.signs, b.signs)
    np.testing.assert_allclose(micro.last_energies, whole.last_energies,
                               rtol=1e-13)


def test_micro_batch_not_dividing_runs_whole_batch(ref_data, caplog):
    """A micro_batch that does not divide the batch runs the whole batch:
    bit for bit the same C(t) and k~ic(t), and a warning."""
    s = _as5(ref_data)
    outs = []
    for micro in (0, 24):
        prop = HermanKlukPropagator(s["G"], s["G"], device="cpu")
        prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                                ntraj=NTRAJ,
                                generator=torch.Generator().manual_seed(2))
        with caplog.at_level("WARNING"):
            outs.append(prop.propagate(s["pot"], s["dt"], 6,
                                       micro_batch=micro))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert "does not divide" in caplog.text


def test_micro_batch_odd_antithetic_subbatch_raises(ref_data):
    s = _as5(ref_data)
    prop = HermanKlukPropagator(s["G"], s["G"], device="cpu")
    prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"], ntraj=48,
                            generator=torch.Generator().manual_seed(2),
                            sampling_method="antithetic")
    with pytest.raises(ValueError, match="even micro-batch"):
        prop.propagate(s["pot"], s["dt"], 2, error_bars=True, micro_batch=3)


# --- the Fourier transforms ------------------------------------------------

SIGMA = 0.01 / np.sqrt(2.0 * np.log(2.0)) / units.hartree_to_ev
LINESHAPES = {"gaussian": (gaussian(SIGMA), jax_gaussian(SIGMA)),
              "lorentzian": (lorentzian(1e-3), jax_lorentzian(1e-3))}


@pytest.mark.parametrize("shape", sorted(LINESHAPES))
def test_spectrum_and_stderr_match_jax(shape):
    rng = np.random.default_rng(9)
    nt = 300
    times = np.linspace(0.0, 2000.0, nt)
    corr = (np.exp(-1j * 0.01 * times - times / 800.0)
            + 0.01 * (rng.standard_normal(nt) + 1j * rng.standard_normal(nt)))
    stderr = 0.002 * np.sqrt(np.arange(nt) + 1.0)
    ls, ls_j = LINESHAPES[shape]
    e, spec = spectrum_from_correlation(times, corr, ls)
    e_j, spec_j = jax_rates.spectrum_from_correlation(times, corr, ls_j)
    np.testing.assert_array_equal(e, e_j)
    assert np.abs(spec - spec_j).max() <= 1e-12 * np.abs(spec_j).max()
    got = fourier_stderr(times, stderr, ls)
    ref = jax_rates.fourier_stderr(times, stderr, ls_j)
    assert abs(got - ref) <= 1e-12 * ref
    with pytest.raises(ValueError, match="start at t=0"):
        fourier_stderr(times + 1.0, stderr, ls)


# --- the CLI against the JAX package's CLI ---------------------------------

@pytest.mark.parametrize("method", ["pseudo", "antithetic", "sobol"])
def test_cli_npz_matches_jax(ref_data, tmp_path, monkeypatch, method):
    """`dynamics` + `rates` + `spectrum` of a 5-mode AS task with
    `error_bars` (two repetitions of 32 trajectories, 20 steps) through
    both CLIs. The JAX CLI draws from its repetition keys unpatched; the
    port is handed the same draws: its generator's Gaussians are those of
    `jax.random.normal` at the same keys, and its sobol scramble seeds
    those the JAX package takes from them. Every npz key, type and shape
    alike; the correlations and their stderr at 1e-8, the rate, spectrum
    and their bands at 1e-6 of their largest values."""
    s = _as5(ref_data)
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": str(s["model"])},
            "propagator": "HK", "batch_size": 32, "num_trajectories": 64,
            "num_steps": 20, "time_step_fs": 0.05, "manual_seed": 3,
            "error_bars": True, "sampling": method,
            "results": {"correlations": str(tmp_path / "port.npz")}}
    post = [{"task": "rates", "broadening": "gaussian", "hwhmG_ev": 0.01},
            {"task": "spectrum", "broadening": "gaussian", "hwhmG_ev": 0.01}]

    jnpz = str(tmp_path / "j.npz")
    jax_cli.run_semiclassical_dynamics(
        dict(task, results={"correlations": jnpz}), num_devices=1,
        precision="f64")
    jax_cli.calculate_rates(dict(post[0], correlations=jnpz, rates=jnpz))
    jax_cli.calculate_spectrum(dict(post[1], correlations=jnpz,
                                    spectrum=jnpz))

    rep_keys = list(jax.random.split(jax.random.key(3), 2))
    draws = iter(rep_keys)
    monkeypatch.setattr(
        port_sampling, "_gaussian",
        lambda shape, generator, dtype, device: torch.tensor(np.asarray(
            jax.random.normal(next(draws), shape, dtype=jnp.float64))))
    monkeypatch.setattr(
        port_sampling, "scramble_seed",
        lambda generator: int(jax.random.randint(next(draws), (), 0,
                                                 np.int32(2**31 - 1))))
    npz = task["results"]["correlations"]
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [
        task, dict(post[0], correlations=npz, rates=npz),
        dict(post[1], correlations=npz, spectrum=npz)]}))
    assert cli.main(["dynamics", str(path), "--device", "cpu"]) == 0
    assert cli.main(["rates", str(path)]) == 0
    assert cli.main(["spectrum", str(path)]) == 0

    got, ref = dict(np.load(npz)), dict(np.load(jnpz))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape and \
            got[key].dtype == ref[key].dtype, key
    assert int(got["trajectories"]) == 64
    for key in ("autocorrelation_stderr", "ic_correlation_stderr"):
        _assert_stderr_close(got[key], ref[key], 1e-8)
    for key, tol in (("autocorrelation", 1e-8), ("ic_correlation", 1e-8),
                     ("ic_rate", 1e-6),
                     ("ic_rate_stderr", 1e-6), ("spectrum", 1e-6),
                     ("spectrum_stderr", 1e-6),
                     ("spectrum_energies", 1e-12)):
        assert np.abs(got[key] - ref[key]).max() <= tol * np.abs(
            ref[key]).max(), key


@pytest.mark.parametrize("key, value, named", [
    ("norm_samples", -1, "norm_samples"),
    ("calc_norm_every", -5, "calc_norm_every"),
    ("micro_batch", -16, "micro_batch"),
    ("sampling", "qmc", "qmc"),
    ("sampling", "antithetic", "even")])
def test_cli_validates_statistics_keywords(ref_data, tmp_path, key, value,
                                           named):
    """Bad statistics keywords are refused before anything runs (an
    antithetic batch of odd size included); no npz is written."""
    s = _as5(ref_data)
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": str(s["model"])},
            "batch_size": 33, "num_trajectories": 33, "num_steps": 2,
            "time_step_fs": 0.05, key: value,
            "results": {"correlations": str(tmp_path / "c.npz")}}
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [task]}))
    with pytest.raises(ConfigurationError, match=named):
        cli.main(["dynamics", str(path), "--device", "cpu"])
    assert not (tmp_path / "c.npz").exists()


def test_cli_sobol_error_bars_warns(ref_data, tmp_path, caplog):
    s = _as5(ref_data)
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": str(s["model"])},
            "batch_size": 32, "num_trajectories": 32, "num_steps": 3,
            "time_step_fs": 0.05, "sampling": "sobol", "error_bars": True,
            "results": {"correlations": str(tmp_path / "c.npz")}}
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [task]}))
    with caplog.at_level("INFO"):
        assert cli.main(["dynamics", str(path), "--device", "cpu"]) == 0
    assert "6x" in caplog.text and "conservative" in caplog.text
    assert "MC stderr" in caplog.text
    assert np.isfinite(np.load(tmp_path / "c.npz")[
        "autocorrelation_stderr"]).all()


# --- the variance reductions of tests/test_sampling_vr.py ------------------

def _harmonic_as():
    """tests/test_sampling_vr.py's 5-mode harmonic AS model and its
    closed-form k~ic."""
    rng = np.random.default_rng(5)
    omega = (np.array([450.0, 780.0, 1100.0, 1680.0, 2400.0])
             / units.hartree_to_wavenumbers)
    S = np.array([0.12, 0.05, 0.20, 0.08, 0.15])
    nac = rng.uniform(-1.0, 1.0, size=5)
    dQ = np.sqrt(2.0 * S / omega)
    nt = 60
    times = np.linspace(0.0, 150.0 / units.autime_to_fs / 40.0, nt)
    A = nac * np.sqrt(omega / (2 * S))
    B = -nac * np.sqrt(omega * S / 2)
    Xt = S[None, :] * np.exp(-1j * omega[None, :] * times[:, None])
    ic_qm = (np.prod(np.exp(-S + Xt), axis=1)
             * (np.sum(A * Xt + B, axis=1) ** 2
                + np.sum(A**2 * Xt, axis=1)))
    pot = MorsePotential.create(omega, np.zeros(5), nac, device="cpu")
    return omega, dQ, pot, times, ic_qm


def _run_hk(model, ntraj, seed, method):
    omega, dQ, pot, times, _ = model
    G = np.diag(omega)
    prop = HermanKlukPropagator(G, G, device="cpu")
    prop.initial_conditions(dQ, np.zeros_like(dQ), G, pot, ntraj=ntraj,
                            generator=torch.Generator().manual_seed(seed),
                            sampling_method=method)
    return prop.propagate(pot, times[1] - times[0], len(times),
                          energy0_es=float(np.sum(0.5 * omega)))


@pytest.mark.parametrize("method", ["antithetic", "sobol"])
def test_unbiased_vs_analytic_oracle(method):
    model = _harmonic_as()
    cauto, kic = _run_hk(model, 8192, 0, method)
    ic_qm = model[4]
    assert abs(cauto[0] - 1.0) < 1e-3
    assert np.allclose(kic, ic_qm, rtol=0.1, atol=0.02 * np.abs(ic_qm).max())


def test_measured_variance_reduction():
    """Spread across 20 independent generators at 1024 trajectories, with
    tests/test_sampling_vr.py's bounds on k~ic and on sobol (sobol cuts
    var C(t) below 5% of pseudo's and var k~ic below 25%, antithetic keeps
    var k~ic below twice) and 0.4 on antithetic's var C: over more
    realizations than the JAX package's ten keys, its ratio does not stay
    below a quarter in either package, so a quarter is not a bound."""
    model = _harmonic_as()

    def spread(method):
        runs = [_run_hk(model, 1024, 100 + k, method) for k in range(20)]
        ca = np.stack([r[0] for r in runs])
        ki = np.stack([r[1] for r in runs])
        return (float(np.mean(np.var(ca, axis=0))),
                float(np.mean(np.var(ki, axis=0))))

    vc_pseudo, vk_pseudo = spread("pseudo")
    vc_anti, vk_anti = spread("antithetic")
    vc_sobol, vk_sobol = spread("sobol")
    assert vc_anti < 0.4 * vc_pseudo, (vc_anti, vc_pseudo)
    assert vk_anti < 2.0 * vk_pseudo, (vk_anti, vk_pseudo)
    assert vc_sobol < 0.05 * vc_pseudo, (vc_sobol, vc_pseudo)
    assert vk_sobol < 0.25 * vk_pseudo, (vk_sobol, vk_pseudo)
