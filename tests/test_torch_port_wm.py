# coding: utf-8
"""The port's dense WM slice against the JAX package on methylium (12
cartesian coordinates, rank-6 vibrational space, dense widths: the dense
path with scan_diag False), at float64 on the CPU, cell width 1e4.

As in tests/test_torch_port_hk.py, both packages build their own potential,
sampling and parameter packs from the vendored fchk fixtures and the same
numpy normals go into both samplers. Tolerances: the packs at atol 1e-12,
the derived quantities (on an identical state) at 1e-9 of each field's
largest entry, the port's fast path against its own full-tensor
observables within 1e-10 relative, and C(t), k~ic(t) of `propagate` at
1e-8 relative to their largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import convert
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                minimize)
from semiclassical_tpu_torch.propagation import WaltonManolopoulosPropagator
from semiclassical_tpu_torch.propagation import wm
from semiclassical_tpu_torch.propagation.hk import hk_prefactor_det
from semiclassical_tpu_torch.sampling import SamplingParams

NTRAJ = 16
DT = 4.0      # a.u.
NSTEPS = 10
CELL = 10000.0


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


@pytest.fixture(scope="module")
def setup(ref_data):
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
            read(JaxFchk, "opt_freq_s0.fchk"), read(JaxFchk, "opt_freq_s1.fchk")),
        jnp.asarray(x0))
    sampling = SamplingParams.create(x0, np.zeros_like(x0), G0, G0, "cpu")
    normals = np.random.default_rng(13).standard_normal(
        (NTRAJ, 2 * sampling.rank))
    return dict(x0=x0, G0=G0, zpe=zpe, pot=pot, pot_j=pot_j,
                sampling=sampling, normals=normals)


def _jax_propagator(s, monkeypatch):
    """A JAX WM propagator whose batch starts at the injected draws."""
    sp = jax_sampling.SamplingParams.create(s["x0"], np.zeros_like(s["x0"]),
                                            s["G0"], s["G0"])
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method:
                        jnp.asarray(s["normals"]))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp, None, NTRAJ)
    prop = JaxWM(s["G0"], s["G0"], CELL, CELL)
    prop.initial_conditions(s["x0"], np.zeros_like(s["x0"]), s["G0"],
                            ntraj=NTRAJ, key=0, potential=s["pot_j"])
    prop.state = JaxTrajState.initial(qi, pi)
    prop._bc = jax_wm.wm_batch_constants(prop.params, qi, pi, log_prob,
                                         potential=s["pot_j"])
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)
    return prop


def _port_propagator(s):
    prop = WaltonManolopoulosPropagator(s["G0"], s["G0"], CELL, CELL,
                                        device="cpu")
    prop.initial_conditions(s["x0"], np.zeros_like(s["x0"]), s["G0"],
                            s["pot"], ntraj=NTRAJ,
                            normals=torch.from_numpy(s["normals"]))
    return prop


def _compare(a, b, name):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _compare(getattr(a, f.name), getattr(b, f.name),
                     f"{name}.{f.name}")
    elif a is None or b is None:
        assert a is None and b is None, name
    elif isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("kind", ["wm_params", "wm_batch_constants"])
def test_packs_match_jax(setup, monkeypatch, kind):
    """The port's own packs equal those converted from the JAX package's."""
    prop_j = _jax_propagator(setup, monkeypatch)
    prop = _port_propagator(setup)
    assert prop.params.rank == 6 and not prop.params.scan_diag
    assert prop_j.params.scan_diag is False
    mine, ref = {
        "wm_params": (prop.params,
                      convert.wm_params(_fields(prop_j.params), "cpu")),
        "wm_batch_constants": (prop.bc, convert.wm_batch_constants(
            _fields(prop_j._bc), "cpu")),
    }[kind]
    _compare(mine, ref, kind)


DERIVED = {
    "wm_derived": ("detA", "detM", "gamma", "CQQ", "CqQ", "PIQ", "Rqq", "RQQ",
                   "RqQ", "Pq", "PQ"),
    "wm_scan_derived": ("detA", "detM", "gamma", "rqq", "rQQ", "rqQ", "Pq_dq",
                        "PQ_dQ", "kfac"),
}


@pytest.mark.parametrize("fn", sorted(DERIVED))
def test_derived_matches_jax(setup, monkeypatch, fn):
    """After 5 JAX steps, both packages' derived quantities on the JAX
    state, field by field."""
    prop_j = _jax_propagator(setup, monkeypatch)
    prop_j.propagate(setup["pot_j"], DT, 5, energy0_es=setup["zpe"])
    prop = _port_propagator(setup)
    state = convert.traj_state(_fields(prop_j.state), "cpu")
    args = {"wm_derived": (), "wm_scan_derived": ("pot",)}[fn]
    ref = getattr(jax_wm, fn)(prop_j.params, prop_j._bc, prop_j.state,
                              *(setup[a + "_j"] for a in args))
    got = getattr(wm, fn)(prop.params, prop.bc, state,
                          *(setup[a] for a in args))
    for name in DERIVED[fn]:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= 1e-9 * np.abs(r).max(), name


def test_fast_path_matches_full_tensors(setup):
    """The scan fast path reproduces the full-tensor observables (the
    in-port oracle, as tests/test_wm_fastpath.py holds the JAX package)."""
    prop = _port_propagator(setup)
    prop.propagate(setup["pot"], DT, 5, energy0_es=setup["zpe"])
    params, bc, state = prop.params, prop.bc, prop.state
    tr_c = prop.tracker.prefactorC.update(hk_prefactor_det(params.hk, state))
    full = wm.wm_derived(params, bc, state)
    sA = prop.tracker.detA.update(full.detA).signs
    sM = prop.tracker.detM.update(full.detM).signs
    cauto_full, kic_full = wm.wm_observables(params, bc, state, full,
                                             tr_c.sqrt(), sA, sM,
                                             setup["pot"])
    fast = wm.wm_scan_derived(params, bc, state, setup["pot"])
    cauto_fast, kic_fast = wm.wm_scan_observables(params, bc, state, fast,
                                                  tr_c.sqrt(), sA, sM)
    assert abs(complex(cauto_fast - cauto_full)) <= 1e-10 * abs(
        complex(cauto_full))
    assert abs(complex(kic_fast - kic_full)) <= 1e-10 * abs(complex(kic_full))


def test_propagate_parity(setup, monkeypatch):
    prop_j = _jax_propagator(setup, monkeypatch)
    prop = _port_propagator(setup)
    cauto_j, kic_j = prop_j.propagate(setup["pot_j"], DT, NSTEPS,
                                      energy0_es=setup["zpe"])
    cauto, kic = prop.propagate(setup["pot"], DT, NSTEPS,
                                energy0_es=setup["zpe"])
    assert cauto.shape == kic.shape == (NSTEPS,)
    assert abs(cauto[0] - 1.0) < 1e-3
    np.testing.assert_allclose(cauto, cauto_j, rtol=0,
                               atol=1e-8 * np.abs(cauto_j).max())
    np.testing.assert_allclose(kic, kic_j, rtol=0,
                               atol=1e-8 * np.abs(kic_j).max())
    for name in ("prefactorC", "detA", "detM"):
        np.testing.assert_array_equal(
            getattr(prop.tracker, name).signs.numpy(),
            np.asarray(prop_j.trackers[name].signs), err_msg=name)
    assert prop.t == pytest.approx(prop_j.t, abs=1e-12)


def test_scan_diag_raises_by_name(setup):
    """Diagonal widths at full rank select the separable WM path (the pack
    carries its per-mode constants) only for a diagonal monodromy: a PES
    whose Hessian is a dense matrix per trajectory (sGDML's kind) takes
    the dense monodromy and the dense WM step. A Hessian of no known
    operator type raises, naming it."""
    from semiclassical_tpu_torch.potentials import DenseHessian

    class DenseHessianPES:
        hessian = staticmethod(lambda n, d, q: DenseHessian(
            torch.eye(d, dtype=q.dtype).expand(n, d, d)))

        def masses(self):
            return torch.ones(3, dtype=torch.float64)

        def local_expansion(self, q):
            n, d = q.shape
            return (0.5 * torch.sum(q * q, dim=1), q.clone(),
                    self.hessian(n, d, q))

        def derivative_coupling_1st(self, q):
            return torch.ones_like(q)

        def derivative_coupling_2nd(self, q):
            return torch.zeros_like(q)

    G = np.diag([0.5, 1.0, 2.0])
    prop = WaltonManolopoulosPropagator(G, G, CELL, CELL, device="cpu")
    prop.initial_conditions(np.zeros(3), np.zeros(3), G, DenseHessianPES(),
                            ntraj=4, generator=torch.Generator().manual_seed(1))
    assert prop.params.scan_diag and prop.params.diag is not None
    assert prop.params.diag_pack.shape == (17, 3)
    assert not prop.state.diag_monodromy
    cauto, kic = prop.propagate(DenseHessianPES(), 0.1, 3)
    assert np.isfinite(cauto).all() and np.isfinite(kic).all()
    assert not _port_propagator(setup).params.scan_diag

    bare = DenseHessianPES()
    bare.hessian = lambda n, d, q: torch.eye(d, dtype=q.dtype)
    with pytest.raises(NotImplementedError, match="Tensor"):
        WaltonManolopoulosPropagator(G, G, CELL, CELL, device="cpu"
                                     ).initial_conditions(
            np.zeros(3), np.zeros(3), G, bare, ntraj=4)
