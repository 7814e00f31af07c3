# coding: utf-8
"""The port's exact integrators on float32 trajectories (`integrator:
"exact"` under `--precision comp32` and `f32`) against the JAX package's,
mode for mode, on the CPU.

Inputs are made with numpy and go into both packages (JAX states cross
over through `convert.traj_state`, JAX draws through the monkeypatched
standard normals). Tolerances, each of the reference's largest modulus:

* the Morse map's build, 25 advances and state (q + qc, p + pc, the four
  monodromy planes, S, the step energies) from the identity, from an
  evolved M0 and with routed rows (a NaN row among them): 2e-6 (XLA's and
  PyTorch's float32 sin, log and atan2 differ by ulps); at float64 the lo
  parts of the split constants are exactly zero;
* the harmonic step with residuals against the step from the folded
  state (tests/test_exact_harmonic.py's twin): 1e-12;
* HK and WM `propagate` on the 12-mode AS model and on methylium, C(t)
  and k~ic(t): 2e-6 (the precision modes' SAME_MODE_TOL); their stderr as
  variances, to 2e-6 of the largest plus the float32 cancellation floor of
  sigma^2 = m2 - |sum|^2 / n (`_assert_stderr`);
* the port's comp32 exact run against its f64 exact run: 5e-4
  (tests/test_exact_morse.py's twin);
* a comp32 exact checkpoint resumed against the uninterrupted run: 2e-6
  (the rebuilt map starts from the float32 state);
* the CLI npz on methylium and on a 2-mode AS model per mode: 2e-6.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation import exact_morse as jax_em
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu.pytree import replace as jax_replace
from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch.checkpoint import (load_propagator_state,
                                                save_propagator_state)
from semiclassical_tpu_torch.potentials import MorsePotential
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator)
from semiclassical_tpu_torch.propagation import exact_harmonic as eh
from semiclassical_tpu_torch.propagation import exact_morse as em
from semiclassical_tpu_torch.propagation.state import TrajState
from test_torch_port_exact import (_close, _harmonic, _methylium, _morse,
                                   _morse_batch, _port_state)
from test_torch_port_precision import (MODES, SAME_MODE_TOL, _as12,
                                       _cli_pair, _draw, _rel,
                                       jax_propagator)

MODES32 = ("comp32", "f32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _true(state, name):
    """q + qc (or p + pc) of a port state at float64."""
    x = getattr(state, name).double()
    c = getattr(state, name + "c")
    return x if c is None else x + c.double()


# --- the Morse map against the JAX package -------------------------------

@pytest.mark.parametrize("case", ["identity", "m0", "routed"])
@pytest.mark.parametrize("mode", MODES32)
def test_morse_map_matches_jax_float32(mode, case):
    """build / 25 x advance / materialise of both packages on one float32
    batch (comp32: with its residuals), from the identity, from an evolved
    M0 (three RK4 steps first) and with routed rows (unbound, near the
    separatrix, NaN) on the RK4 side-channel."""
    comp = mode == "comp32"
    _, pot_j64, q0, _, omega = _morse(d=5, seed=5)
    pot_j = jax_potentials.MorsePotential.create(
        np.asarray(pot_j64.omega), np.full(5, 0.02), np.asarray(pot_j64.nac),
        dtype=jnp.float32)
    pot = MorsePotential.create(np.asarray(pot_j64.omega), np.full(5, 0.02),
                                np.asarray(pot_j64.nac), device="cpu",
                                dtype=torch.float32)
    qi, pi = _morse_batch(pot_j64, q0, omega, hot=case == "routed")
    state_j = JaxTrajState.initial(
        jnp.asarray(qi), jnp.asarray(pi), dtype=None if comp else jnp.float32,
        mono_dtype=jnp.float32, diag_monodromy=True, compensated=comp)
    if case == "m0":
        for _ in range(3):
            state_j, _ = jax_eom.rk4_step(state_j, pot_j, 3.0)
    dt = 4.0
    pack_j, carry_j = jax_em.build_morse_map(state_j, pot_j, dt)
    pack, carry = em.build_morse_map(_port_state(state_j), pot, dt)
    assert (pack.m0 is not None) == pack_j.compose_m0 == (case == "m0")
    assert (pack.sub_idx is not None) == pack_j.has_sub == (case == "routed")
    assert pack.s.dtype == carry.th.dtype == torch.float32
    assert pack.A.dtype == pack.S_base.dtype == torch.float64
    for name in ("bco_lo", "wdt_lo"):
        assert getattr(pack, name).abs().max() > 0.0, name
    for _ in range(25):
        _, en_j = jax_em.morse_map_state(pack_j, carry_j, jnp.float32, pot_j)
        carry_j = jax_em.morse_map_advance(pack_j, carry_j, 4.0, pot_j)
        carry, en = em.morse_map_advance(pack, carry, dt, pot)
        _close(float(en), float(en_j), 2e-6, "energy")
    ref, _ = jax_em.morse_map_state(pack_j, carry_j, jnp.float32, pot_j)
    ref = _port_state(jax_em.morse_map_merge(pack_j, carry_j, ref))
    got = em.morse_map_state(pack, carry)
    assert got.compensated == comp and got.q.dtype == torch.float32
    assert got.S.dtype == (torch.float64 if comp else torch.float32)
    assert got.Z.dtype == torch.float32
    for name in ("q", "p"):
        _close(_true(got, name).numpy(), _true(ref, name).numpy(), 2e-6, name)
    _close(got.S.double().numpy(), ref.S.double().numpy(), 2e-6, "S")
    _close(got.Z.double().numpy(), ref.Z.double().numpy(), 2e-6, "Z")
    if comp:
        # the closed-form rows have zero residuals, the routed rows theirs
        bound = np.ones(qi.shape[0], bool)
        if pack.sub_idx is not None:
            bound[pack.sub_idx.numpy()] = False
        assert not got.qc[bound].any() and not got.pc[bound].any()


def test_float64_split_has_no_lo_part():
    """At float64 the map's (hi, lo) constants carry everything in hi: the
    f64 and mixed modes take the unsplit arithmetic."""
    pot, _, q0, _, omega = _morse(d=4, seed=2)
    rng = np.random.default_rng(1)
    qi = q0[None, :] + rng.normal(0, 0.3, (16, 4)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.5, (16, 4)) * np.sqrt(omega)[None, :]
    state = TrajState.initial(torch.from_numpy(qi), torch.from_numpy(pi),
                              diag_monodromy=True)
    pack, carry = em.build_morse_map(state, pot, 2.0)
    for x in (pack.bco_lo, pack.wdt_lo, carry.thc):
        assert x.dtype == torch.float64 and not x.any()
    assert em._split_float(7.3, torch.float64) == (7.3, 0.0)
    hi, lo = em._split_float(7.3, torch.float32)
    assert lo != 0.0 and abs(hi + lo - 7.3) < 1e-14


def test_comp32_step_folds_both_residuals():
    """tests/test_exact_harmonic.py's twin: one exact step from (v,
    residual) equals one step from (v + residual, 0) in q, p, S and the
    step energy (a dropped p-fold breaks it at the residual scale)."""
    pot, _ = _harmonic(d=4, seed=30)
    rng = np.random.default_rng(31)
    n, d = 8, 4
    q = pot.pos0.numpy()[None, :] + 0.3 * rng.standard_normal((n, d))
    p = 5.0 * rng.standard_normal((n, d))
    rng = np.random.default_rng(32)
    qc, pc = 1e-3 * rng.standard_normal((2, n, d))
    t = torch.from_numpy
    Z = torch.eye(2 * d, dtype=torch.float64).expand(n, 2 * d, 2 * d)
    split = TrajState(q=t(q), p=t(p), Z=Z,
                      S=torch.zeros(n, dtype=torch.float64), qc=t(qc),
                      pc=t(pc))
    zeros = torch.zeros(n, d, dtype=torch.float64)
    folded = dataclasses.replace(split, q=t(q + qc), p=t(p + pc), qc=zeros,
                                 pc=zeros)
    hmap = eh.build_harmonic_map(pot, 25.0, split)
    s_split, e_split = eh.harmonic_step(hmap, split, pot)
    s_fold, e_fold = eh.harmonic_step(hmap, folded, pot)
    for name in ("q", "p"):
        np.testing.assert_allclose(_true(s_split, name).numpy(),
                                   _true(s_fold, name).numpy(), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(s_split.S.numpy(), s_fold.S.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(float(e_split), float(e_fold), rtol=1e-12,
                               atol=0)


# --- the propagators against the JAX package -----------------------------

NTRAJ, NSTEPS = 128, 20


def _jax_exact(cls, G, q0, pot_j, draw, mode, mp, *args, diag=True):
    """`jax_propagator` with integrator "exact"."""
    return jax_propagator(functools.partial(cls, integrator="exact"), G, q0,
                          pot_j, draw, mode, mp, *args, diag=diag)


def _port_exact(cls, G, q0, pot, draw, mode, *args):
    _, _, dtype, traj = MODES[mode]
    prop = cls(G, G, *args, device="cpu", dtype=dtype, traj_dtype=traj,
               integrator="exact")
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=draw.shape[0],
                            normals=torch.from_numpy(draw))
    return prop


def _models(model, ref_data):
    """(port potential at float32 parameters or contractions, JAX potential
    likewise, q0, G, en0, dt, diagonal representation)."""
    if model == "as12":
        omega, chi, nac, q0 = _as12()
        return (MorsePotential.create(omega, chi, nac, device="cpu",
                                      dtype=torch.float32),
                jax_potentials.MorsePotential.create(omega, chi, nac,
                                                     dtype=jnp.float32),
                q0, np.diag(omega), float(omega.sum() / 2), 2.0, True)
    pot, pot_j, q0, G, zpe = _methylium(ref_data)
    return (cli._reduced_potential(pot, torch.float32),
            jax_replace(pot_j, contract_dtype="float32"), q0, G, zpe, 4.0,
            False)


def _assert_stderr(got, ref, curve, n):
    """The stderr of a float32 run against the JAX package's, compared as
    variances: sigma^2 = m2 - |sum|^2 / n cancels, and the float32 sums
    (the JAX package's factored moments, both packages' complex64 curves)
    leave an absolute error of order eps32 (sigma^2 + |C|^2 / n) on it;
    where the variance is that small (C(0) = 1 exactly in the limit) the
    two packages' stderr are both rounding noise."""
    floor = 64 * np.finfo(np.float32).eps * (ref**2 + np.abs(curve)**2 / n)
    assert (np.abs(got**2 - ref**2)
            <= SAME_MODE_TOL * ref.max()**2 + floor).all()


PROP_CASES = [(m, n, mode) for m in ("as12", "methylium")
              for n in ("HK", "WM") for mode in MODES32]


@pytest.mark.parametrize("model, name, mode", PROP_CASES,
                         ids=[f"{m}-{n}-{mode}" for m, n, mode in PROP_CASES])
def test_propagate_exact_matches_jax(ref_data, monkeypatch, model, name,
                                     mode):
    """propagate(error_bars=True) with integrator "exact" of both packages
    in the same mode from the same draws, in two calls (the map's carry
    persists): C(t), k~ic(t) and their stderr at 2e-6 of their largest
    value; the state's dtypes those of the mode."""
    pot, pot_j, q0, G, en0, dt, diag = _models(model, ref_data)
    rank = 12 if model == "as12" else 6
    draw = _draw(NTRAJ, rank, seed=23)
    args = (500.0, 500.0) if name == "WM" else ()
    cls_j, cls = ((JaxWM, WaltonManolopoulosPropagator) if name == "WM"
                  else (JaxHK, HermanKlukPropagator))
    pj = _jax_exact(cls_j, G, q0, pot_j, draw, mode, monkeypatch, *args,
                    diag=diag)
    pp = _port_exact(cls, G, q0, pot, draw, mode, *args)
    for nt in (NSTEPS // 2, NSTEPS // 2):
        ref = pj.propagate(pot_j, dt, nt, energy0_es=en0, error_bars=True,
                           check_energy=False)
        got = pp.propagate(pot, dt, nt, energy0_es=en0, error_bars=True,
                           check_energy=False)
        for g, r in zip(got[:2], ref[:2]):
            assert _rel(g, r) <= SAME_MODE_TOL
        for g, r, c in zip(got[2:], ref[2:], ref[:2]):
            _assert_stderr(g, r, c, NTRAJ)
    st = pp.state
    assert st.q.dtype == st.Z.dtype == torch.float32
    assert st.compensated == (mode == "comp32")
    assert st.S.dtype == (torch.float64 if mode == "comp32"
                          else torch.float32)
    assert pp.cdtype == torch.complex64


def test_exact_comp32_matches_f64():
    """tests/test_exact_morse.py's twin: the comp32 exact run (float32
    state, two-sum phase carry) against the f64 exact run from the same
    draws, within 5e-4."""
    pot64, _, q0, G, _ = _morse(d=12, seed=4)
    pot32 = pot64.to_dtype(torch.float32)
    draw = _draw(1024, 12, seed=6)
    c64, k64 = _port_exact(HermanKlukPropagator, G, q0, pot64, draw,
                           "f64").propagate(pot64, 2.0, 100)
    cc, kc = _port_exact(HermanKlukPropagator, G, q0, pot32, draw,
                         "comp32").propagate(pot32, 2.0, 100)
    assert np.abs(cc - c64).max() < 5e-4
    assert np.abs(kc - k64).max() / np.abs(k64).max() < 5e-4


def test_exact_comp32_checkpoint_resume(tmp_path):
    """A comp32 exact run saved after 10 steps and resumed in a fresh
    propagator (the map rebuilt from the restored state, qc and pc
    restored, M0 != identity composed) follows the uninterrupted run: the
    head bit for bit, the tail within 2e-6 of the largest modulus (the
    rebuilt map starts from the state as materialised, float32 values with
    zero residuals, where the uninterrupted phase carries its two-sum
    residual on)."""
    pot64, _, q0, G, _ = _morse(d=5, seed=9)
    pot = pot64.to_dtype(torch.float32)
    draw = _draw(128, 5, seed=4)

    def fresh():
        return _port_exact(HermanKlukPropagator, G, q0, pot, draw, "comp32")

    c_full, _ = fresh().propagate(pot, 2.0, 20)
    head = fresh()
    c_head, _ = head.propagate(pot, 2.0, 10)
    fn = str(tmp_path / "ck.npz")
    save_propagator_state(fn, head)
    tail = fresh()
    load_propagator_state(fn, tail)
    for name in ("q", "qc", "p", "pc", "S", "Z"):
        np.testing.assert_array_equal(getattr(tail.state, name).numpy(),
                                      getattr(head.state, name).numpy())
    c_tail, _ = tail.propagate(pot, 2.0, 10)
    assert tail._morse.pack.m0 is not None
    np.testing.assert_array_equal(c_head, c_full[:10])
    assert _rel(c_tail, c_full[10:]) <= SAME_MODE_TOL


# --- the CLI against the JAX CLI -----------------------------------------

@pytest.fixture()
def methylium_task(ref_data):
    from test_torch_port_precision import EXAMPLE
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")
    with open(EXAMPLE) as f:
        task = json.load(f)["semi"][0]
    task["potential"].update(ground=str(base / "opt_freq_s0.fchk"),
                             excited=str(base / "opt_freq_s1.fchk"),
                             coupling=str(base / "opt_freq_s1.fchk"))
    task.update(num_trajectories=32, batch_size=32, num_steps=20,
                manual_seed=5, integrator="exact")
    return task


@pytest.mark.parametrize("mode", MODES32)
def test_cli_methylium_exact_matches_jax(methylium_task, tmp_path,
                                         monkeypatch, mode):
    """Methylium with integrator "exact" through both CLIs (WM at
    `mode`: K1, K2 and K3 at complex64 on the card): the npz keys and
    dtypes, C(t) and k~ic(t) at 2e-6."""
    methylium_task.update(propagator="WM", cell_width=1e4)
    got, ref = _cli_pair(methylium_task, mode, tmp_path, monkeypatch, rank=6)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
    assert abs(got["autocorrelation"][0] - 1.0) < 1e-3
    for key in ("autocorrelation", "ic_correlation"):
        assert _rel(got[key], ref[key]) <= SAME_MODE_TOL, key


@pytest.mark.parametrize("mode", MODES32)
def test_cli_as_exact_matches_jax(tmp_path, monkeypatch, mode):
    """A 2-mode AS model with integrator "exact" through both CLIs (HK at
    `mode`, 256 trajectories x 20 steps): C(0) = 1, finite, C(t) and
    k~ic(t) at 2e-6."""
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": "AS_model.dat"},
            "propagator": "HK", "batch_size": 256, "num_trajectories": 256,
            "num_steps": 20, "time_step_fs": 0.05, "integrator": "exact"}
    got, ref = _cli_pair(task, mode, tmp_path, monkeypatch, rank=2)
    for d in (got, ref):
        assert abs(d["autocorrelation"][0] - 1.0) < 1e-3
        assert np.isfinite(d["autocorrelation"]).all()
    for key in ("autocorrelation", "ic_correlation"):
        assert _rel(got[key], ref[key]) <= SAME_MODE_TOL, key
