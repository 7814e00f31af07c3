# coding: utf-8
"""The port's norm diagnostic, coefficients and wavefunctions against the
JAX package at float64 on the CPU, and its HK and WM against the 1D
split-operator oracle of tests/qm_oracle.py.

Both packages start from the same numpy normals (5-mode AS model: the
diagonal Morse state; methylium: the dense, rank-deficient state) and
propagate 10 steps each; tolerances: the pair-overlap matrix and the grid
wavefunctions of coherent.py at 1e-12 relative, coefficients,
log-coefficients, wavefunctions and norms at 1e-10 relative, the blocked
pair sums against each other at 1e-12; the oracle at
tests/test_propagators_1d.py's gates.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import coherent as jax_coherent
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu import units
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import cli, coherent
from semiclassical_tpu_torch import sampling as port_sampling
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                MorsePotential,
                                                NonHarmonicPotential,
                                                minimize)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator,
                                                 hk, wm)

from qm_oracle import (gaussian_wavepacket, momentum_operator,
                       split_operator_correlations,
                       split_operator_wavefunctions)

NTRAJ = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
NSTEPS = 10
CELL = 500.0


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --- coherent.py -----------------------------------------------------------

def _spd(d, rng, rank=None):
    A = rng.standard_normal((d, rank or d))
    return A @ A.T / d + (0.0 if rank else 0.5 * np.eye(d))


@pytest.mark.parametrize("rank", [None, 3], ids=["full", "rank3"])
def test_overlap_matrix_matches_jax(rank):
    rng = np.random.default_rng(1)
    d = 5
    Gi, Gj = _spd(d, rng, rank), _spd(d, rng, rank)
    if rank:
        Gj = Gi + 0.1 * Gi @ Gi      # same null space
    qi, pi = rng.standard_normal((2, 7, d))
    qj, pj = rng.standard_normal((2, 9, d))
    ov = coherent.OverlapParams.create(Gi, Gj, "cpu")
    ov_j = jax_coherent.OverlapParams.create(Gi, Gj)
    t = torch.from_numpy
    re, im = coherent.overlap_exponent_matrix(ov, t(qi), t(pi), t(qj), t(pj))
    re_j, im_j = jax_coherent.overlap_exponent_matrix(ov_j, qi, pi, qj, pj)
    assert _rel(re.numpy(), re_j) < 1e-12 and _rel(im.numpy(), im_j) < 1e-12
    got = coherent.overlap_matrix(ov, t(qi), t(pi), t(qj), t(pj)).numpy()
    assert _rel(got, jax_coherent.overlap_matrix(ov_j, qi, pi, qj, pj)) < 1e-12
    # the diagonal of the pair matrix is overlap_vector's row
    vec = coherent.overlap_vector(ov, t(qi), t(pi), t(qj[0]), t(pj[0]))
    assert _rel(got[:, 0], vec.numpy()) < 1e-12


def test_wavefunctions_match_jax():
    rng = np.random.default_rng(2)
    d, n = 3, 11
    G = _spd(d, rng)
    q, p = rng.standard_normal((2, n, d))
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    log_v = (rng.standard_normal(n) - 3.0, rng.uniform(-3, 3, n))
    x = rng.standard_normal((13, d))
    wf = coherent.WavefunctionParams.create(G, "cpu")
    wf_j = jax_coherent.WavefunctionParams.create(G)
    assert abs(wf.fac - float(wf_j.fac)) < 1e-15 and wf.rank == wf_j.rank
    t = torch.from_numpy
    got = coherent.wavefunction(wf, t(q), t(p), t(v), t(x)).numpy()
    assert _rel(got, jax_coherent.wavefunction(wf_j, q, p, v, x)) < 1e-12
    psi, zmax = coherent.wavefunction_log(wf, t(q), t(p),
                                          tuple(map(t, log_v)), t(x))
    psi_j, zmax_j = jax_coherent.wavefunction_log(wf_j, q, p, log_v, x)
    assert _rel(psi.numpy() * np.exp(zmax.numpy()),
                np.asarray(psi_j) * np.exp(np.asarray(zmax_j))) < 1e-12


# --- the propagators' coefficients, wavefunctions and norms -----------------

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


MODELS = {"as5": _as5, "methylium": _methylium}


@pytest.fixture(scope="module", params=[
    (m, n) for m in MODELS for n in ("HK", "WM")],
    ids=lambda c: "-".join(c))
def propagated(request, ref_data):
    """A port and a JAX propagator from the same normals, each propagated
    NSTEPS steps on its own."""
    model, name = request.param
    s = MODELS[model](ref_data)
    G, q0 = s["G"], s["q0"]
    sp = port_sampling.SamplingParams.create(q0, 0 * q0, G, G, "cpu")
    normals = np.random.default_rng(19).standard_normal((NTRAJ, 2 * sp.rank))
    args = (CELL, CELL) if name == "WM" else ()
    prop = (WaltonManolopoulosPropagator if name == "WM"
            else HermanKlukPropagator)(G, G, *args, device="cpu")
    prop.initial_conditions(q0, 0 * q0, G, s["pot"], ntraj=NTRAJ,
                            normals=torch.from_numpy(normals))

    sp_j = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sampling, "_standard_normals",
                   lambda params, key, ntraj, m: jnp.asarray(normals))
        qi, pi, log_prob = jax_sampling.sample_initial_conditions(
            sp_j, None, NTRAJ)
    prop_j = (JaxWM if name == "WM" else JaxHK)(G, G, *args)
    prop_j.initial_conditions(q0, 0 * q0, G, ntraj=NTRAJ, key=0,
                              potential=s["pot_j"])
    prop_j.state = JaxTrajState.initial(
        qi, pi, diag_monodromy=prop.state.diag_monodromy)
    make_bc = (jax_wm.wm_batch_constants if name == "WM"
               else jax_hk.hk_batch_constants)
    prop_j._bc = make_bc(prop_j.params, qi, pi, log_prob,
                         potential=s["pot_j"])
    prop_j.trackers = prop_j._make_trackers(prop_j.state)
    prop.propagate(s["pot"], s["dt"], NSTEPS, energy0_es=s["en0"])
    prop_j.propagate(s["pot_j"], s["dt"], NSTEPS, energy0_es=s["en0"])
    return dict(s, prop=prop, prop_j=prop_j, name=name, model=model)


def test_coefficients_match_jax(propagated):
    prop, prop_j = propagated["prop"], propagated["prop_j"]
    assert _rel(prop.coefficients().numpy(), prop_j.coefficients()) < 1e-10
    lr, li = prop.log_coefficients()
    lr_j, li_j = prop_j.log_coefficients()
    assert np.abs(lr - lr_j).max() < 1e-10 * np.abs(lr_j).max()
    # the phase to 2 pi: compare exp(i arg)
    assert np.abs(np.exp(1j * li) - np.exp(1j * li_j)).max() < 1e-10
    # exp(log v) is the linear coefficient where that is finite
    assert _rel(np.exp(lr + 1j * li), prop.coefficients().numpy()) < 1e-12


def test_prefactor_and_correlations_match_jax(propagated):
    """The granular accessors at the propagated state: C(t), k~ic(t) and
    the prefactor, and the state accessors."""
    s, prop, prop_j = propagated, propagated["prop"], propagated["prop_j"]
    assert _rel(prop.semiclassical_prefactor().numpy(),
                prop_j.semiclassical_prefactor()) < 1e-10
    got = (prop.autocorrelation(s["en0"]),
           prop.ic_correlation(s["pot"], s["en0"]))
    ref = (prop_j.autocorrelation(s["en0"]),
           prop_j.ic_correlation(s["pot_j"], s["en0"]))
    for g, r in zip(got, ref):
        assert abs(g - r) < 1e-10 * abs(r)
    for a, b in zip((*prop.current_positions_and_momenta(),
                     prop.classical_action(), *prop.monodromy_matrices()),
                    (*prop_j.current_positions_and_momenta(),
                     prop_j.classical_action(),
                     *prop_j.monodromy_matrices())):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   atol=1e-11)
    # (the JAX package's WM accessor reads its HK constants' fields from
    # the WM constants, which nest them under `base`, and raises)
    bc_j = prop_j._bc.base if s["name"] == "WM" else prop_j._bc
    for a, b in zip(prop.initial_positions_and_momenta(), (bc_j.qi, bc_j.pi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)


def test_wavefunction_matches_jax(propagated):
    prop, prop_j = propagated["prop"], propagated["prop_j"]
    rng = np.random.default_rng(4)
    x = propagated["q0"][None, :] + 0.3 * rng.standard_normal(
        (9, propagated["q0"].size))
    assert _rel(prop.wavefunction(x), prop_j.wavefunction(x)) < 1e-10


def test_norm_matches_jax(propagated):
    """|psi| at the propagated state equals the JAX package's to 1e-10
    relative: exact in one block, exact in uneven blocks of 24 (the JAX
    package's host loop), and subsampled over every block pair (stderr
    0). The HK sum doubles the off-diagonal blocks of the pair matrix's
    upper triangle, as the JAX package does; at methylium's rank-deficient
    widths that matrix is not Hermitian (the imaginary exponent is not
    antisymmetric in the null space), so there the value depends on the
    blocks — in both packages alike. Elsewhere it does not."""
    prop, prop_j = propagated["prop"], propagated["prop_j"]
    ref = prop_j.norm()
    got = prop.norm()
    assert np.isfinite(got) and abs(got - ref) < 1e-10 * ref
    if propagated["name"] == "HK":
        # the linear-coefficient norm, where those are finite
        linear = hk.pairwise_norm(prop.params.csott, prop.state.q,
                                  prop.state.p, prop.coefficients())
        assert abs(linear - got) < 1e-10 * got
    if propagated["name"] == "WM":
        log_v, derived = prop_j._log_coefficients_and_derived()
        ref7 = jax_wm.wm_norm(prop_j.params, prop_j._bc, prop_j.state,
                              derived, log_v, block=24)
    else:
        log_v = jax_hk.hk_log_coefficients(
            prop_j.params, prop_j._bc, prop_j.state,
            prop_j.semiclassical_prefactor())
        ref7 = jax_hk.pairwise_norm_log(prop_j.params.csott, prop_j.state.q,
                                        prop_j.state.p, log_v, block=24)
    got7 = prop.norm(block=24)
    assert abs(got7 - ref7) < 1e-10 * ref7
    if (propagated["name"], propagated["model"]) != ("HK", "methylium"):
        assert abs(got7 - got) < 1e-12 * got
    est, err = prop.norm(sample_pairs=10**6)
    est_j, err_j = prop_j.norm(sample_pairs=10**6)
    assert err == err_j == 0.0
    assert abs(est - est_j) < 1e-10 * est_j


# --- the pair sums ------------------------------------------------------------

@pytest.mark.parametrize("name", ["HK", "WM"])
def test_blocked_pair_sum_equals_host_loop(ref_data, name):
    """The device loop over block pairs (uneven blocks included) equals a
    loop over single bra rows on the host, each row against the whole
    batch; HK over its Hermitian triangle, WM over the ordered grid."""
    s = _as5(ref_data)
    args = (CELL, CELL) if name == "WM" else ()
    prop = (WaltonManolopoulosPropagator if name == "WM"
            else HermanKlukPropagator)(s["G"], s["G"], *args, device="cpu")
    prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                            ntraj=40,
                            generator=torch.Generator().manual_seed(6))
    prop.propagate(s["pot"], s["dt"], 4)
    if name == "WM":
        log_v, derived = prop._log_coefficients_and_derived()
        pack, arrays = wm.wm_norm_arrays(prop.params, prop.bc, prop.state,
                                         derived, log_v)
        term, hermitian = wm._wm_norm_block_term, False
    else:
        pack = prop.params.csott
        arrays = (prop.state.q, prop.state.p, *prop._log_coefficients())
        term, hermitian = hk._hk_norm_log_block_term, True
    n = arrays[0].shape[0]
    host = 0.0
    for i in range(n):
        host += complex(term(pack, *(a[i:i + 1] for a in arrays),
                             *arrays)).real
    for block in (n, 16, 7):
        got = hk.blocked_pair_sum(term, pack, arrays, block,
                                  hermitian=hermitian)
        assert abs(got - host) < 1e-12 * abs(host), block
    # a subset of block pairs
    part = hk.blocked_pair_sum(term, pack, arrays, 8, hermitian=hermitian,
                               pairs=[(0, 1), (2, 2)])
    t01, t22 = (complex(term(pack, *(a[i:i + 8] for a in arrays),
                             *(a[j:j + 8] for a in arrays))).real
                for i, j in ((0, 8), (16, 16)))
    want = (2.0 * t01 if hermitian else t01) + t22
    assert abs(part - want) < 1e-12 * abs(want)


def test_subsampled_norm_within_error_bar(ref_data):
    """The exhaustive draw is the exact sum with stderr 0; otherwise an
    unbiased estimate with an honest stderr: across 8 pair draws the
    standardized pulls against the exact norm scatter like N(0, 1)."""
    s = _as5(ref_data)
    prop = HermanKlukPropagator(s["G"], s["G"], device="cpu")
    prop.initial_conditions(s["q0"], 0 * s["q0"], s["G"], s["pot"],
                            ntraj=512,
                            generator=torch.Generator().manual_seed(8))
    prop.propagate(s["pot"], s["dt"], 6)
    exact = prop.norm()
    # every one of the 28 off-diagonal block pairs drawn: the exact sum
    est, err = prop.norm(sample_pairs=28, key=1, block=64)
    assert err == 0.0 and abs(est - exact) < 1e-12 * exact
    pulls = []
    for key in range(8):
        est, err = prop.norm(sample_pairs=10, key=key, block=64)
        assert err > 0.0
        pulls.append((est - exact) / err)
    pulls = np.asarray(pulls)
    assert abs(pulls.mean()) < 2.0, pulls
    assert (np.abs(pulls) < 3.0).mean() >= 0.75, pulls
    # one key, one draw
    assert prop.norm(sample_pairs=10, key=3, block=64) == prop.norm(
        sample_pairs=10, key=3, block=64)


def test_pair_block_rule():
    """The block of a pair sum fits the device's memory budget: 4096 for
    the HK norm on the card, the WM norm's methylium pair matrices
    (d = 12, r = 6) at 2 GiB, small on the CPU, never above n."""
    assert hk.pair_block(131072, hk.HK_PAIR_BYTES, "cuda") == 4096
    b = hk.pair_block(10000, wm.wm_pair_bytes(12, 6), "cuda")
    assert b * b * wm.wm_pair_bytes(12, 6) <= hk.PAIR_BUDGET_BYTES["cuda"]
    assert (b + 1) ** 2 * wm.wm_pair_bytes(12, 6) > \
        hk.PAIR_BUDGET_BYTES["cuda"]
    assert hk.pair_block(10**6, hk.HK_PAIR_BYTES, "cpu") == 512
    assert hk.pair_block(100, hk.HK_PAIR_BYTES, "cuda") == 100


# --- the 1D split-operator oracle ---------------------------------------------

# tests/test_propagators_1d.py's 20,000 trajectories for HK; WM at 8000,
# where its O(n^2) norm (an r x r inverse per pair, the plain version of K3
# on the CPU) stays at seconds on one thread
ORACLE_NTRAJ = {"HK": 20000, "WM": 8000}


@pytest.fixture(scope="module")
def oracle_1d():
    """tests/test_propagators_1d.py's setup: the HK (1986) eqn. 7
    potential, a displaced Gaussian, 100 steps over 12/40 periods."""
    nt = 4000 // 40
    omega = 1.0
    times = np.linspace(0.0, (12.0 / 40) * 2.0 * np.pi / omega, nt)
    x = np.linspace(-10.0, 40.0, 10000)
    eps, b = 0.975, 12.0 ** (-0.5)
    v = (eps / (2 * b**2) * (1.0 - np.exp(-b * x)) ** 2
         + (1 - eps) * 0.5 * omega * x**2)
    phi0 = gaussian_wavepacket(x, 7.3, 0.0, 0.5 * omega)
    en0 = 0.5 * omega
    return dict(times=times, dt=times[1] - times[0], nt=nt, x=x, v=v,
                phi0=phi0, en0=en0,
                cauto_qm=split_operator_correlations(v, x, times, phi0),
                kic_qm=(split_operator_correlations(
                    v, x, times, momentum_operator(phi0, x))
                    * np.exp(1j * times * en0)),
                pot=NonHarmonicPotential.create(device="cpu"),
                q0=np.array([7.3]), G0=np.array([[omega]]),
                Gi=np.array([[5.0]]))


def _oracle_prop(s, name, seed=0):
    if name == "WM":
        prop = WaltonManolopoulosPropagator(s["Gi"], s["Gi"], 100.0, 100.0,
                                            device="cpu")
    else:
        prop = HermanKlukPropagator(s["Gi"], s["Gi"], device="cpu")
    prop.initial_conditions(s["q0"], np.zeros(1), s["G0"], s["pot"],
                            ntraj=ORACLE_NTRAJ[name],
                            generator=torch.Generator().manual_seed(seed))
    return prop


@pytest.mark.parametrize("name", ["HK", "WM"])
def test_propagators_vs_qm(oracle_1d, name):
    """C(t), k~ic(t) and the final norm against split-operator QM at
    tests/test_propagators_1d.py's gates (WM's k~ic at 0.1 of its
    largest value)."""
    s = oracle_1d
    prop = _oracle_prop(s, name)
    cauto, kic = prop.propagate(s["pot"], s["dt"], s["nt"], energy0_es=0.0)
    kic = kic * np.exp(1j * s["times"] * s["en0"])
    assert np.allclose(cauto, s["cauto_qm"], rtol=0.05, atol=0.05)
    if name == "HK":
        assert np.allclose(kic, s["kic_qm"], rtol=0.05, atol=0.05)
    else:
        assert np.allclose(kic, s["kic_qm"], rtol=0.1,
                           atol=0.1 * np.abs(s["kic_qm"]).max())
    assert abs(prop.norm() - 1.0) < 0.05


@pytest.mark.parametrize("name", ["HK", "WM"])
def test_wavefunction_vs_qm(oracle_1d, name):
    """psi(x, t) on a subgrid against the split-operator wavefunction at
    four snapshots (L2 error < 0.1), and the t = 0 grid norm within 0.05
    of 1."""
    s = oracle_1d
    save = [0, s["nt"] // 3, 2 * s["nt"] // 3, s["nt"] - 1]
    psi_qm = split_operator_wavefunctions(s["v"], s["x"], s["times"],
                                          s["phi0"], save)
    x_sub = s["x"][::10][:, None]
    dx = x_sub[1, 0] - x_sub[0, 0]
    prop = _oracle_prop(s, name, seed=1)
    errors, prev = [], 0
    for step in save:
        if step > prev:
            prop.propagate(s["pot"], s["dt"], step - prev)
            prev = step
        psi = prop.wavefunction(x_sub)
        if step == 0:
            assert abs(np.sqrt(np.sum(np.abs(psi) ** 2) * dx) - 1.0) < 0.05
        errors.append(float(np.sqrt(np.sum(
            np.abs(psi - psi_qm[step][::10]) ** 2) * dx)))
    assert max(errors) < 0.1, errors


# --- the CLI's norm lines ----------------------------------------------------

def _norm_lines(records):
    return [r.getMessage() for r in records if "norm=" in r.getMessage()]


@pytest.mark.parametrize("samples", [0, 4], ids=["exact", "subsampled"])
def test_cli_norm_lines(ref_data, tmp_path, monkeypatch, caplog, samples):
    """`calc_norm_every` logs the norm before every segment, in the JAX
    CLI's wording; exact norms equal the JAX CLI's at the same draws to
    the digits printed, `norm_samples` adds the stderr."""
    s = _as5(ref_data)
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": str(s["model"])},
            "batch_size": 64, "num_trajectories": 64, "num_steps": 12,
            "time_step_fs": 0.05, "manual_seed": 3, "calc_norm_every": 4,
            "error_bars": True,
            "results": {"correlations": str(tmp_path / "port.npz")}}
    if samples:
        task["norm_samples"] = samples
    with caplog.at_level("INFO", logger=jax_cli.logger.name):
        jax_cli.run_semiclassical_dynamics(
            dict(task, results={"correlations": str(tmp_path / "j.npz")}),
            num_devices=1, precision="f64")
    ref = _norm_lines(caplog.records)
    caplog.clear()

    key = jax.random.split(jax.random.key(3), 1)[0]
    monkeypatch.setattr(
        port_sampling, "_gaussian",
        lambda shape, generator, dtype, device: torch.tensor(np.asarray(
            jax.random.normal(key, shape, dtype=jnp.float64))))
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [task]}))
    with caplog.at_level("INFO", logger=cli.logger.name):
        assert cli.main(["dynamics", str(path), "--device", "cpu"]) == 0
    got = _norm_lines(caplog.records)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        t_g, n_g = g.split("norm=")
        t_r, n_r = r.split("norm=")
        assert t_g == t_r
        assert ("+-" in n_g) == ("+-" in n_r) == bool(samples)
        value, value_j = (float(x.split("+-")[0]) for x in (n_g, n_r))
        assert np.isfinite(value) and value > 0
        if not samples:
            assert abs(value - value_j) <= 1.5e-6
    data = np.load(tmp_path / "port.npz")
    np.testing.assert_allclose(data["autocorrelation"],
                               np.load(tmp_path / "j.npz")["autocorrelation"],
                               rtol=0, atol=1e-8)
