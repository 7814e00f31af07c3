# coding: utf-8
"""The port's checkpoint/resume (`semiclassical_tpu_torch.checkpoint` and
the CLI's `checkpoint` / `checkpoint_every`): the twins of
tests/test_checkpoint.py (but the mesh-sharded restore) and
tests/test_cli_checkpoint.py, and the exact map's resume of
tests/test_exact_morse.py, on the CPU.

A killed-and-resumed run reproduces the uninterrupted one: RK4 to the
last bit in the state and at 1e-12 in C(t) (the host phase of a resumed
segment starts from the accumulated time), the exact Morse map at 1e-10
(the map is rebuilt from the restored state and composes its monodromy).
A checkpoint of another layout raises ValueError naming the key.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import semiclassical_tpu_torch.checkpoint as ckpt_mod
from semiclassical_tpu_torch import cli
from semiclassical_tpu_torch.checkpoint import (CheckpointedRun,
                                                load_propagator_state,
                                                save_propagator_state)
from semiclassical_tpu_torch.potentials import (MorsePotential,
                                                NonHarmonicPotential)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs its files in several worker
    processes, and PyTorch's threads oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GI = np.array([[2 * 2.5]])
G0 = np.array([[1.0]])


def _make_prop(pot, seed=5, cls=HermanKlukPropagator, args=(), ntraj=2000):
    prop = cls(GI, GI, *args, device="cpu")
    prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0, pot,
                            ntraj=ntraj,
                            generator=torch.Generator().manual_seed(seed))
    return prop


def test_resume_matches_uninterrupted(tmp_path):
    pot = NonHarmonicPotential.create(device="cpu")
    dt, nt, en0 = 0.02, 40, 0.5
    prop_a = _make_prop(pot)
    cauto_a, kic_a = prop_a.propagate(pot, dt, nt, energy0_es=en0)

    # "killed" after two segments of 10
    ckpt = str(tmp_path / "ckpt.npz")
    prop_b = _make_prop(pot)
    cauto = np.zeros(nt, dtype=complex)
    kic = np.zeros(nt, dtype=complex)
    cauto[:10], kic[:10] = prop_b.propagate(pot, dt, 10, energy0_es=en0)
    cauto[10:20], kic[10:20] = prop_b.propagate(pot, dt, 10, energy0_es=en0)
    save_propagator_state(ckpt, prop_b, partial={"cauto": cauto, "kic": kic,
                                                 "steps_done": 20})

    # resumed by a fresh propagator drawn from another seed (overwritten)
    prop_c = _make_prop(pot, seed=999)
    cauto_c, kic_c, err_c, err_k = CheckpointedRun(
        ckpt, prop_c, pot, dt=dt, nt=nt, energy0_es=en0, segment=10).run()
    assert err_c is None and err_k is None
    np.testing.assert_allclose(cauto_c, cauto_a, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kic_c, kic_a, rtol=1e-12, atol=1e-14)
    for name in ("q", "p", "Z", "S"):
        assert torch.equal(getattr(prop_c.state, name),
                           getattr(prop_a.state, name)), name
    assert torch.equal(prop_c.tracker.signs, prop_a.tracker.signs)
    assert prop_c.t == pytest.approx(prop_a.t, rel=1e-14)


def test_chunked_propagation_matches_single_scan():
    pot = NonHarmonicPotential.create(device="cpu")
    ca, ka = _make_prop(pot).propagate(pot, 0.02, 30, energy0_es=0.5)
    cb, kb = _make_prop(pot).propagate(pot, 0.02, 30, energy0_es=0.5,
                                       chunk=7)
    np.testing.assert_allclose(cb, ca, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kb, ka, rtol=1e-12, atol=1e-14)


def test_wm_checkpoint_roundtrip(tmp_path):
    pot = NonHarmonicPotential.create(device="cpu")
    args = (100.0, 100.0)
    prop = _make_prop(pot, seed=2, cls=WaltonManolopoulosPropagator,
                      args=args, ntraj=500)
    prop.propagate(pot, 0.02, 10, energy0_es=0.5)
    ckpt = str(tmp_path / "wm.npz")
    save_propagator_state(ckpt, prop)
    ref = prop.autocorrelation(energy0_es=0.5)
    prop2 = _make_prop(pot, seed=77, cls=WaltonManolopoulosPropagator,
                       args=args, ntraj=500)
    assert load_propagator_state(ckpt, prop2) == {}
    assert prop2.t == prop.t
    assert prop2.bc.weight_scale == prop.bc.weight_scale
    assert abs(prop2.autocorrelation(energy0_es=0.5) - ref) < 1e-12


def _morse(d=5, seed=9):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(300.0, 2800.0, size=d) / 219474.63
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    return (MorsePotential.create(omega, np.full(d, 0.02), nac, device="cpu"),
            np.sqrt(2 * S / omega), np.diag(omega))


@pytest.mark.parametrize("name", ["HK", "WM"])
def test_exact_checkpoint_resume(tmp_path, name):
    """The exact map resumed from a checkpoint re-derives its constants
    from the restored state (M0 != identity composes): 1e-10."""
    pot, q0, G = _morse()
    args = (200.0, 200.0) if name == "WM" else ()
    cls = WaltonManolopoulosPropagator if name == "WM" else \
        HermanKlukPropagator

    def fresh(seed=4):
        prop = cls(G, G, *args, device="cpu", integrator="exact")
        prop.initial_conditions(q0, np.zeros(5), G, pot, ntraj=128,
                                generator=torch.Generator().manual_seed(seed))
        return prop

    c_full, k_full = fresh().propagate(pot, 2.0, 20)
    prop1 = fresh()
    c_head, k_head = prop1.propagate(pot, 2.0, 10)
    fn = str(tmp_path / "ck.npz")
    save_propagator_state(fn, prop1)
    prop2 = fresh(seed=99)
    load_propagator_state(fn, prop2)
    c_tail, k_tail = prop2.propagate(pot, 2.0, 10)
    assert prop2._morse.pack.m0 is not None
    np.testing.assert_allclose(np.concatenate([c_head, c_tail]), c_full,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.concatenate([k_head, k_tail]), k_full,
                               rtol=0, atol=1e-10 * np.abs(k_full).max())


def test_layout_mismatch_raises_naming_the_key(tmp_path):
    """A checkpoint of another representation, batch size or propagator
    kind is refused with the key it stumbles on."""
    pot, q0, G = _morse()
    diag = HermanKlukPropagator(G, G, device="cpu")
    diag.initial_conditions(q0, np.zeros(5), G, pot, ntraj=64,
                            generator=torch.Generator().manual_seed(1))
    fn = str(tmp_path / "diag.npz")
    save_propagator_state(fn, diag)

    dense = HermanKlukPropagator(G, G, device="cpu")
    dense.initial_conditions(q0, np.zeros(5), G, pot, ntraj=64,
                             generator=torch.Generator().manual_seed(1))
    dense.state = type(dense.state)(q=dense.state.q, p=dense.state.p,
                                    Z=dense.state.dense_Z(), S=dense.state.S)
    with pytest.raises(ValueError, match="'state/Z'"):
        load_propagator_state(fn, dense)

    small = HermanKlukPropagator(G, G, device="cpu")
    small.initial_conditions(q0, np.zeros(5), G, pot, ntraj=32,
                             generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="shape mismatch for 'state/q'"):
        load_propagator_state(fn, small)

    wm = WaltonManolopoulosPropagator(G, G, 200.0, 200.0, device="cpu")
    wm.initial_conditions(q0, np.zeros(5), G, pot, ntraj=64,
                          generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError,
                       match="missing 'tracker/prefactorC/previous'"):
        load_propagator_state(fn, wm)


# --- the CLI's checkpoint / checkpoint_every ------------------------------

@pytest.fixture()
def as_task(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("# freq/cm-1  S  nac  chi\n")
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    return {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": "AS_model.dat"},
        "propagator": "HK",
        "batch_size": 128,
        "num_trajectories": 256,   # 2 repetitions
        "num_steps": 40,
        "time_step_fs": 0.05,
        "manual_seed": 7,
        "checkpoint": "ckpt.npz",
        "checkpoint_every": 10,    # 4 segments per repetition
        "results": {"correlations": "correlations.npz"},
    }


def _run(task):
    return cli.run_semiclassical_dynamics(task, device="cpu")


@pytest.mark.parametrize("keys", [
    {}, {"integrator": "exact"}, {"error_bars": True}],
    ids=["rk4", "exact", "error_bars"])
def test_cli_kill_and_resume(as_task, monkeypatch, keys):
    """Killed in repetition 2 while writing its second checkpoint, then run
    again: the run resumes from the surviving checkpoint (repetition 2,
    step 10) and its npz equals the uninterrupted run's."""
    as_task.update(keys)
    clean = copy.deepcopy(as_task)
    clean["checkpoint"] = "ckpt_clean.npz"
    clean["results"] = {"correlations": "clean.npz"}
    _run(clean)
    ref = dict(np.load("clean.npz"))
    assert not os.path.exists("ckpt_clean.npz")

    real_save = ckpt_mod.save_propagator_state
    calls = {"n": 0}

    def killing_save(filename, propagator, partial=None):
        calls["n"] += 1
        if calls["n"] == 6:
            raise KeyboardInterrupt
        real_save(filename, propagator, partial)

    with monkeypatch.context() as m:
        m.setattr(ckpt_mod, "save_propagator_state", killing_save)
        with pytest.raises(KeyboardInterrupt):
            _run(as_task)
    assert int(np.load("correlations.npz")["trajectories"]) == 128
    meta = ckpt_mod.peek_checkpoint("ckpt.npz")
    assert int(meta["repetition"]) == 1 and int(meta["steps_done"]) == 10

    timer = _run(as_task)
    assert not os.path.exists("ckpt.npz")
    out = dict(np.load("correlations.npz"))
    assert sorted(out) == sorted(ref)
    assert int(out["trajectories"]) == 256
    tol = 1e-10 if keys.get("integrator") == "exact" else 1e-12
    for key in ("autocorrelation", "ic_correlation", "autocorrelation_stderr",
                "ic_correlation_stderr"):
        if key in ref:
            np.testing.assert_allclose(out[key], ref[key], rtol=0,
                                       atol=tol * np.abs(ref[key]).max())
    assert "scan" in timer.phases


def test_cli_checkpoint_main_json(as_task):
    with open("input.json", "w") as f:
        json.dump({"semi": [as_task]}, f)
    assert cli.main(["dynamics", "input.json", "--device", "cpu"]) == 0
    d = np.load("correlations.npz")
    assert int(d["trajectories"]) == 256
    assert abs(d["autocorrelation"][0] - 1.0) < 1e-3


def test_cli_checkpoint_with_norm_monitoring(as_task, caplog):
    """`checkpoint` and `calc_norm_every` compose: the segments split at
    the norm boundaries (0, 15, 30 of each 40-step repetition), the norm is
    logged there, and the npz equals the plain checkpointed run's."""
    plain = copy.deepcopy(as_task)
    plain["checkpoint"] = "ckpt_plain.npz"
    plain["results"] = {"correlations": "plain.npz"}
    _run(plain)
    ref = dict(np.load("plain.npz"))
    combo = copy.deepcopy(as_task)
    combo["checkpoint"] = "ckpt_combo.npz"
    combo["calc_norm_every"] = 15
    combo["results"] = {"correlations": "combo.npz"}
    with caplog.at_level("INFO"):
        _run(combo)
    out = dict(np.load("combo.npz"))
    assert len([r for r in caplog.messages if "norm=" in r]) == 6
    for key in ("autocorrelation", "ic_correlation"):
        np.testing.assert_allclose(out[key], ref[key], atol=1e-12)


def test_cli_resume_without_error_bars_drops_stderr(as_task, monkeypatch,
                                                    caplog):
    """A checkpoint written without error bars, resumed with them: the
    resumed repetition has no stderr (zeros would be wrong values), so the
    npz carries none."""
    real_save = ckpt_mod.save_propagator_state
    calls = {"n": 0}

    def killing_save(filename, propagator, partial=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        real_save(filename, propagator, partial)

    with monkeypatch.context() as m:
        m.setattr(ckpt_mod, "save_propagator_state", killing_save)
        with pytest.raises(KeyboardInterrupt):
            _run(as_task)
    as_task["error_bars"] = True
    with caplog.at_level("WARNING"):
        _run(as_task)
    assert "written without error_bars" in caplog.text
    out = dict(np.load("correlations.npz"))
    assert int(out["trajectories"]) == 256
    assert "autocorrelation_stderr" not in out
