# coding: utf-8
"""The AS model's reduced-cost Hessian in the port (`MorsePotential`'s
`hessian_eval` "step" / "taylor" and `taylor_every`) against the JAX
package, on the CPU.

The same numpy-made states and draws go into both packages. Tolerances:

* `rk4_step` on the diagonal state over 20 steps, "step" and "taylor": q,
  p, S and the monodromy planes at 1e-12 of each field's largest value;
  "step"'s q, p and S equal "stage"'s bit for bit;
* the `taylor_every` window's expansion (midpoint, value, gradient,
  diagonal Hessian) at 1e-12, no window monodromy map;
* HK and WM `propagate` with `taylor_every` 4 at f64 (C(t), k~ic(t) at
  1e-10 of their largest modulus) and "taylor" under comp32 (2e-6);
* the twins of tests/test_hessian_eval.py's separable Morse tests, at
  their own gates;
* `convert.morse_potential` round trip and the JAX package's validation;
* the CLI npz against the JAX CLI's (C(t), k~ic(t) at 1e-10), with the
  `hessian_eval` log line.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import cli, convert
from semiclassical_tpu_torch.potentials import MorsePotential
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator,
                                                 eom, hk)
from test_torch_port_exact import _close, _fields, _port_state
from test_torch_port_precision import (MODES, SAME_MODE_TOL, _as12, _draw,
                                       _rel, jax_propagator, port_propagator)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(hessian_eval="stage", taylor_every=1, d=6, mode="f64"):
    """(port, JAX) MorsePotential of the 12-mode family (its first `d`
    modes) at `mode`'s parameter dtype."""
    omega, chi, nac, q0 = _as12(d=d)
    kw = dict(hessian_eval=hessian_eval, taylor_every=taylor_every)
    return (MorsePotential.create(omega, chi, nac, device="cpu",
                                  dtype=MODES[mode][2], **kw),
            jax_potentials.MorsePotential.create(omega, chi, nac,
                                                 dtype=MODES[mode][0], **kw),
            q0)


def _diag_state(q0, n=24, seed=4):
    omega = _as12(d=q0.size)[0]
    rng = np.random.default_rng(seed)
    q = q0 + rng.standard_normal((n, q0.size)) / np.sqrt(2 * omega)
    p = rng.standard_normal((n, q0.size)) * np.sqrt(omega / 2)
    return JaxTrajState.initial(jnp.asarray(q), jnp.asarray(p),
                                diag_monodromy=True)


def _assert_state(got, ref_j, tol):
    ref = _port_state(ref_j)
    for name in ("q", "p", "S", "Z"):
        _close(getattr(got, name).numpy(), getattr(ref, name).numpy(), tol,
               name)


@pytest.mark.parametrize("hessian_eval", ["step", "taylor"])
def test_rk4_step_matches_jax(hessian_eval):
    """20 RK4 steps of one diagonal state in both packages at 1e-12."""
    pot, pot_j, q0 = _pair(hessian_eval)
    state_j = _diag_state(q0)
    state = _port_state(state_j)
    step_j = lambda s: jax_eom.rk4_step(s, pot_j, 20.0)
    for _ in range(20):
        state, e = eom.rk4_step(state, pot, 20.0)
        state_j, e_j = step_j(state_j)
        _close(float(e), float(e_j), 1e-12, "energy")
    _assert_state(state, state_j, 1e-12)


def test_step_keeps_the_stage_trajectories():
    """"step" freezes the midpoint Hessian for the monodromy only: q, p and
    S equal "stage"'s bit for bit, the monodromy moves."""
    pot_s, _, q0 = _pair("stage")
    pot_t, _, _ = _pair("step")
    st_s = st_t = _port_state(_diag_state(q0))
    for _ in range(20):
        st_s, _ = eom.rk4_step(st_s, pot_s, 20.0)
        st_t, _ = eom.rk4_step(st_t, pot_t, 20.0)
    for name in ("q", "p", "S"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      getattr(st_s, name).numpy())
    assert not torch.equal(st_t.Z, st_s.Z)


def test_window_expansion_matches_jax():
    """The window's local quadratic at the free-flight midpoint of 4 steps:
    the diagonal Hessian, no window monodromy map (the diagonal path steps
    the planes), and 12 windowed steps in both packages at 1e-12."""
    pot, pot_j, q0 = _pair("taylor", 4)
    state_j = _diag_state(q0)
    state = _port_state(state_j)
    c0_j, step_j = jax_eom.make_taylor_window(pot_j, 20.0, 4)
    c0, step = eom.make_taylor_window(pot, 20.0, 4)
    carry_j, carry = c0_j(state_j), c0(state)
    quad, quad_j = carry[0], carry_j[0]
    assert quad.Tmono is None and quad_j.Tmono is None
    assert quad.H.shape == state.q.shape
    for name in ("q_mid", "v0", "g0", "H", "nac0"):
        _close(getattr(quad, name).numpy(), np.asarray(getattr(quad_j, name)),
               1e-12, name)
    for _ in range(12):
        state, e, carry = step(state, carry)
        state_j, e_j, carry_j = step_j(state_j, carry_j)
        _close(float(e), float(e_j), 1e-12, "energy")
    assert carry[1] == int(carry_j[1]) == 12
    _assert_state(state, state_j, 1e-12)


PROP_CASES = [("HK", "f64", 4), ("WM", "f64", 4), ("HK", "comp32", 1),
              ("WM", "comp32", 4)]


@pytest.mark.parametrize("name, mode, every", PROP_CASES,
                         ids=[f"{n}-{m}-every{e}" for n, m, e in PROP_CASES])
def test_propagate_taylor_matches_jax(monkeypatch, name, mode, every):
    """HK / WM `propagate` of the 12-mode model with hessian_eval "taylor"
    (and `taylor_every`) in both packages from the same draws, in segments
    of 10 steps (the window restarts at each): C(t) and k~ic(t) at 1e-10
    of their largest modulus at f64, 2e-6 under comp32."""
    omega, chi, nac, q0 = _as12()
    G = np.diag(omega)
    pot, pot_j, _ = _pair("taylor", every, d=12, mode=mode)
    draw = _draw(128, 12, seed=31)
    args = (500.0, 500.0) if name == "WM" else ()
    cls_j, cls = ((JaxWM, WaltonManolopoulosPropagator) if name == "WM"
                  else (JaxHK, HermanKlukPropagator))
    pj = jax_propagator(cls_j, G, q0, pot_j, draw, mode, monkeypatch, *args)
    pp = port_propagator(cls, G, q0, pot, draw, mode, *args)
    en0 = float(omega.sum() / 2)
    ref = pj.propagate(pot_j, 2.0, 30, energy0_es=en0, chunk=10,
                       check_energy=False)
    got = pp.propagate(pot, 2.0, 30, energy0_es=en0, chunk=10,
                       check_energy=False)
    tol = 1e-10 if mode == "f64" else SAME_MODE_TOL
    for g, r in zip(got, ref):
        assert _rel(g, r) <= tol
    assert pp.state.diag_monodromy
    assert pp.state.compensated == (mode == "comp32")


def test_exact_takes_no_window(monkeypatch):
    """integrator "exact" with a taylor_every potential: the closed-form
    map does not use the window, and the RK4 side-channel (two injected hot
    rows) steps by the potential's per-step "taylor", as in the JAX
    package: C(t) and k~ic(t) at 1e-10 of JAX's, and bit for bit the run
    with taylor_every 1."""
    import dataclasses
    import functools

    from semiclassical_tpu.pytree import replace as jax_replace

    omega, chi, nac, q0 = _as12(d=5)
    G = np.diag(omega)
    draw = _draw(64, 5, seed=8)
    pot, pot_j, _ = _pair("taylor", 4, d=5)
    D = pot.D.numpy()

    def hot(p):
        p = np.array(p)
        p[3, 0] = np.sqrt(2.1 * D[0])
        p[40, 2] = np.sqrt(1.9 * D[2] * 0.95)
        return p

    pj = jax_propagator(functools.partial(JaxHK, integrator="exact"), G, q0,
                        pot_j, draw, "f64", monkeypatch)
    pj.state = jax_replace(pj.state, p=jnp.asarray(hot(pj.state.p)))
    ref = pj.propagate(pot_j, 2.0, 20, check_energy=False)
    runs = []
    for p in (pot, dataclasses.replace(pot, taylor_every=1)):
        prop = HermanKlukPropagator(G, G, "cpu", integrator="exact")
        prop.initial_conditions(q0, 0 * q0, G, p, ntraj=64,
                                normals=torch.from_numpy(draw))
        prop.state = dataclasses.replace(
            prop.state, p=torch.from_numpy(hot(prop.state.p.numpy())))
        runs.append(prop.propagate(p, 2.0, 20, check_energy=False))
        assert prop._morse.pack.sub_idx.tolist() == [3, 40]
    for g, r in zip(runs[0], ref):
        assert _rel(g, r) <= 1e-10
    for g, r in zip(*runs):
        np.testing.assert_array_equal(g, r)


# --- twins of tests/test_hessian_eval.py (separable Morse) ---------------

def _morse(hessian_eval="stage", taylor_every=1, d=3, dtype=torch.float64):
    rng = np.random.default_rng(2)
    omega = rng.uniform(0.004, 0.01, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    return MorsePotential.create(omega, np.full(d, 0.02), nac, device="cpu",
                                 dtype=dtype, hessian_eval=hessian_eval,
                                 taylor_every=taylor_every)


def _run_morse(pot, nt=32, dt=1.0, ntraj=32, seed=9, **kw):
    d = pot.dimensions()
    Gamma = np.diag(pot.omega.double().numpy())
    prop = HermanKlukPropagator(Gamma, Gamma, "cpu", **kw)
    prop.initial_conditions(np.full(d, 0.25), np.zeros(d), Gamma, pot,
                            ntraj=ntraj,
                            normals=torch.from_numpy(_draw(ntraj, d, seed)))
    assert prop.state.diag_monodromy
    cauto, kic = prop.propagate(pot, dt, nt, energy0_es=0.05)
    return prop.state, cauto, kic


def test_morse_taylor_second_order_convergence():
    pot_s, pot_t = _morse("stage"), _morse("taylor")

    def gap(dt, nt):
        s1, _, _ = _run_morse(pot_s, nt=nt, dt=dt)
        s2, _, _ = _run_morse(pot_t, nt=nt, dt=dt)
        return max(float((s1.q - s2.q).abs().max()),
                   float((s1.p - s2.p).abs().max()))

    g_coarse = gap(4.0, 8)
    g_fine = gap(2.0, 16)
    assert g_coarse > 0.0
    assert g_coarse / g_fine > 3.0


def test_morse_taylor_window_close_and_monodromy_diag():
    pot_t, pot_w = _morse("taylor"), _morse("taylor", taylor_every=4)
    _, c_t, _ = _run_morse(pot_t, nt=16, dt=1.0)
    s_w, c_w, _ = _run_morse(pot_w, nt=16, dt=1.0)
    assert s_w.diag_monodromy
    assert np.abs(c_w - c_t).max() > 0.0
    np.testing.assert_allclose(c_w, c_t, rtol=0, atol=5e-5)

    def gap(dt, nt):
        s1, _, _ = _run_morse(pot_t, nt=nt, dt=dt)
        s2, _, _ = _run_morse(pot_w, nt=nt, dt=dt)
        return float((s1.q - s2.q).abs().max())

    assert gap(2.0, 8) / gap(1.0, 16) > 3.0


def test_morse_taylor_comp32():
    """taylor on comp32 trajectories runs, stays finite and tracks the f64
    taylor run at the comp32 scale (5e-4)."""
    _, c64, _ = _run_morse(_morse("taylor"), nt=25, ntraj=64, seed=11)
    _, c32, k32 = _run_morse(_morse("taylor", dtype=torch.float32), nt=25,
                             ntraj=64, seed=11, dtype=torch.float32,
                             traj_dtype="comp32")
    np.testing.assert_allclose(c32, c64, rtol=0, atol=5e-4)
    assert np.isfinite(k32).all()


def test_window_without_taylor_raises_at_propagate():
    """A potential built around the validation (dataclass replace) with a
    window and no "taylor" is refused by the time loop."""
    import dataclasses

    pot = dataclasses.replace(_morse("step"), taylor_every=4)
    with pytest.raises(ValueError, match="taylor_every"):
        _run_morse(pot, nt=4)


# --- convert, validation, the CLI ----------------------------------------

def test_convert_round_trip_and_validation():
    """`convert.morse_potential` keeps both fields; `create` refuses what
    the JAX package refuses, with its words."""
    _, pot_j, _ = _pair("taylor", 4)
    pot = convert.morse_potential(_fields(pot_j), "cpu")
    assert (pot.hessian_eval, pot.taylor_every) == ("taylor", 4)
    np.testing.assert_array_equal(pot.a.numpy(), np.asarray(pot_j.a))
    assert pot.to_dtype(torch.float32).taylor_every == 4
    omega, chi, nac, _ = _as12(d=2)
    for kw, msg in (({"hessian_eval": "midpoint"}, "unknown hessian_eval"),
                    ({"taylor_every": 0}, "taylor_every must be >= 1"),
                    ({"hessian_eval": "step", "taylor_every": 2},
                     "requires hessian_eval='taylor'")):
        for create in (lambda: MorsePotential.create(omega, chi, nac,
                                                     device="cpu", **kw),
                       lambda: jax_potentials.MorsePotential.create(
                           omega, chi, nac, **kw)):
            with pytest.raises(ValueError, match=msg):
                create()


@pytest.mark.parametrize("name, keys", [
    ("HK", {"hessian_eval": "taylor", "taylor_every": 4}),
    ("WM", {"hessian_eval": "step"})])
def test_cli_npz_matches_jax(tmp_path, monkeypatch, caplog, name, keys):
    """A 2-mode AS model with the reduced-cost Hessian through both CLIs
    (256 trajectories x 20 steps at f64, the port handed the JAX draws):
    the npz keys, C(t) and k~ic(t) at 1e-10, the hessian_eval line."""
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": "AS_model.dat", **keys},
            "propagator": name, "cell_width": 1e4, "batch_size": 256,
            "num_trajectories": 256, "num_steps": 20, "time_step_fs": 0.25}
    draw = _draw(256, 2)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method: jnp.asarray(draw))
    sample = hk.sample_initial_conditions
    monkeypatch.setattr(hk, "sample_initial_conditions",
                        lambda params, ntraj, generator=None, normals=None:
                        sample(params, ntraj, normals=torch.from_numpy(draw)))
    out = {}
    for side in ("port", "jax"):
        npz = str(tmp_path / f"{side}.npz")
        t = dict(task, results={"correlations": npz})
        with caplog.at_level("INFO"):
            if side == "port":
                path = tmp_path / "semi.json"
                path.write_text(json.dumps({"semi": [t]}))
                assert cli.main(["dynamics", str(path), "--device",
                                 "cpu"]) == 0
            else:
                jax_cli.run_semiclassical_dynamics(t, num_devices=1,
                                                   precision="f64")
        out[side] = dict(np.load(npz))
    line = ("  hessian_eval                              : "
            f"{keys['hessian_eval']}"
            + (" (re-expansion every 4 steps)" if "taylor_every" in keys
               else ""))
    assert [r.getMessage() for r in caplog.records].count(line) == 2
    got, ref = out["port"], out["jax"]
    assert sorted(got) == sorted(ref)
    for key in ("autocorrelation", "ic_correlation"):
        assert _rel(got[key], ref[key]) <= 1e-10, key
