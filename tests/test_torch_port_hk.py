# coding: utf-8
"""The port's HK slice against the JAX package on methylium (12 cartesian
coordinates, rank-6 vibrational space: the rank-deficient dense-prefactor
path), at float64 on the CPU.

Both packages build their own potential, sampling and parameter packs from
the vendored fchk fixtures; the same standard normals, made with numpy, go
into both samplers (the JAX side gets them by replacing its normal draw,
as tests/test_torch_parity_molecular.py injects initial conditions).
Tolerances are those of tests/test_torch_parity_molecular.py: q, p, S at
atol 1e-9, the sign-tracked prefactor C at atol 1e-8, C(t) and k~ic(t) at
1e-8 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import convert
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                minimize)
from semiclassical_tpu_torch.propagation import HermanKlukPropagator, hk
from semiclassical_tpu_torch.propagation import eom
from semiclassical_tpu_torch.sampling import (SamplingParams,
                                              sample_initial_conditions)

NTRAJ = 16
DT = 4.0      # a.u.
NSTEPS = 10


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
    normals = np.random.default_rng(11).standard_normal(
        (NTRAJ, 2 * sampling.rank))
    return dict(x0=x0, G0=G0, zpe=zpe, pot=pot, pot_j=pot_j,
                sampling=sampling, normals=normals)


def _jax_draw(s, monkeypatch):
    """JAX's (qi, pi, log_prob) from the injected normals."""
    sp = jax_sampling.SamplingParams.create(s["x0"], np.zeros_like(s["x0"]),
                                            s["G0"], s["G0"])
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method:
                        jnp.asarray(s["normals"]))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp, None, NTRAJ)
    return sp, qi, pi, log_prob


def _jax_propagator(s, monkeypatch):
    """A JAX HK propagator whose batch starts at the injected draws."""
    _, qi, pi, log_prob = _jax_draw(s, monkeypatch)
    prop = JaxHK(s["G0"], s["G0"])
    prop.initial_conditions(s["x0"], np.zeros_like(s["x0"]), s["G0"],
                            ntraj=NTRAJ, key=0, potential=s["pot_j"])
    prop.state = JaxTrajState.initial(qi, pi)
    prop._bc = jax_hk.hk_batch_constants(prop.params, qi, pi, log_prob,
                                         potential=s["pot_j"])
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)
    return prop


def _port_propagator(s):
    prop = HermanKlukPropagator(s["G0"], s["G0"], device="cpu")
    prop.initial_conditions(s["x0"], np.zeros_like(s["x0"]), s["G0"],
                            s["pot"], ntraj=NTRAJ,
                            normals=torch.from_numpy(s["normals"]))
    return prop


def test_sampling_matches(setup, monkeypatch):
    sp, qi, pi, log_prob = _jax_draw(setup, monkeypatch)
    assert setup["sampling"].rank == sp.rank == 6
    q, p, lp = sample_initial_conditions(
        setup["sampling"], NTRAJ, normals=torch.from_numpy(setup["normals"]))
    for mine, ref in ((q, qi), (p, pi), (lp, log_prob)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)


def test_state_derivative_matches(setup):
    rng = np.random.default_rng(2)
    q = setup["x0"][None] + 0.05 * rng.standard_normal((4, 12))
    p = 0.05 * rng.standard_normal((4, 12))
    st = eom.TrajState.initial(torch.from_numpy(q), torch.from_numpy(p))
    st = eom.TrajState(q=st.q, p=st.p, S=st.S,
                       Z=st.Z + 0.1 * torch.from_numpy(
                           rng.standard_normal((4, 24, 24))))
    dst, e = eom.state_derivative(st, setup["pot"])
    blocks = dict(Mqq=st.Mqq, Mqp=st.Mqp, Mpq=st.Mpq, Mpp=st.Mpp)
    st_j = JaxTrajState(q=jnp.asarray(q), p=jnp.asarray(p),
                        S=jnp.zeros(4),
                        **{k: jnp.asarray(v.numpy()) for k, v in blocks.items()})
    dst_j, e_j = jax_eom.state_derivative(st_j, setup["pot_j"])
    for name in ("q", "p", "S", "Mqq", "Mqp", "Mpq", "Mpp"):
        np.testing.assert_allclose(getattr(dst, name).numpy(),
                                   np.asarray(getattr(dst_j, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert abs(float(e) - float(e_j)) < 1e-12


@pytest.mark.parametrize("name, shape", [("ConstHessian", (5, 5)),
                                         ("DenseHessian", (3, 5, 5)),
                                         ("DiagHessian", (3, 5))])
def test_hessian_operators_match(name, shape):
    from semiclassical_tpu.potentials import base as jax_base
    from semiclassical_tpu_torch.potentials import base

    rng = np.random.default_rng(len(shape))
    H = rng.standard_normal(shape)
    field = "diag" if name == "DiagHessian" else "mat"
    mine = getattr(base, name)(**{field: torch.from_numpy(H)})
    ref = getattr(jax_base, name)(**{field: jnp.asarray(H)})
    M = rng.standard_normal((3, 5, 5))
    v = rng.standard_normal((3, 5))
    np.testing.assert_allclose(mine.matmul(torch.from_numpy(M)).numpy(),
                               np.asarray(ref.matmul(jnp.asarray(M))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mine.matvec(torch.from_numpy(v)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(v))),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["potential", "sampling", "hk_params",
                                  "batch_constants", "traj_state"])
def test_convert_reproduces_port_objects(setup, monkeypatch, kind):
    """convert.* from the JAX packs gives the port's own objects."""
    prop_j = _jax_propagator(setup, monkeypatch)
    prop = _port_propagator(setup)
    mine, ref = {
        "potential": (setup["pot"], convert.molecular_harmonic_potential(
            _fields(setup["pot_j"]), "cpu")),
        "sampling": (setup["sampling"], convert.sampling_params(
            _fields(prop_j.sampling), "cpu")),
        "hk_params": (prop.params, convert.hk_params(
            _fields(prop_j.params), "cpu")),
        "batch_constants": (prop.bc, convert.batch_constants(
            _fields(prop_j._bc), "cpu")),
        "traj_state": (prop.state, convert.traj_state(
            _fields(prop_j.state), "cpu")),
    }[kind]

    def compare(a, b, name):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                compare(getattr(a, f.name), getattr(b, f.name),
                        f"{name}.{f.name}")
        elif a is None or b is None:
            assert a is None and b is None, name
        elif isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=name)
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-12, err_msg=name)

    compare(mine, ref, kind)


def _close(a, b, rtol):
    assert abs(complex(a) - complex(b)) <= rtol * abs(complex(b)), (a, b)


def test_per_step_parity(setup, monkeypatch):
    prop_j = _jax_propagator(setup, monkeypatch)
    prop = _port_propagator(setup)
    pot, pot_j = setup["pot"], setup["pot_j"]
    for step in range(NSTEPS):
        for name in ("q", "p", "S"):
            np.testing.assert_allclose(
                getattr(prop.state, name).numpy(),
                np.asarray(getattr(prop_j.state, name)), rtol=0, atol=1e-9,
                err_msg=f"{name} step {step}")

        tracker_j = prop_j.trackers["prefactorC"].update(
            jax_hk.hk_prefactor_det(prop_j.params, prop_j.state))
        prop_j.trackers["prefactorC"] = tracker_j
        c_j = jnp.sqrt(tracker_j.previous) * tracker_j.signs
        prop.tracker = prop.tracker.update(
            hk.hk_prefactor_det(prop.params, prop.state))
        c = prop.tracker.sqrt()
        np.testing.assert_allclose(c.numpy(), np.asarray(c_j), rtol=0,
                                   atol=1e-8, err_msg=f"C step {step}")

        cauto_j, kic_j = jax_hk.hk_observables(prop_j.params, prop_j._bc,
                                               prop_j.state, c_j, pot_j)
        cauto, kic = hk.hk_observables(prop.params, prop.bc, prop.state, c,
                                       pot)
        _close(cauto * prop.bc.weight_scale,
               complex(cauto_j) * prop_j._bc.weight_scale, 1e-8)
        _close(kic * prop.bc.weight_scale,
               complex(kic_j) * prop_j._bc.weight_scale, 1e-8)

        prop_j.step(pot_j, DT)
        prop.step(pot, DT)


def test_propagate_parity(setup, monkeypatch):
    prop_j = _jax_propagator(setup, monkeypatch)
    prop = _port_propagator(setup)
    cauto_j, kic_j = prop_j.propagate(setup["pot_j"], DT, 20,
                                      energy0_es=setup["zpe"])
    cauto, kic = prop.propagate(setup["pot"], DT, 20, energy0_es=setup["zpe"])
    assert cauto.shape == kic.shape == (20,)
    assert abs(cauto[0] - 1.0) < 1e-3
    np.testing.assert_allclose(cauto, cauto_j, rtol=0,
                               atol=1e-8 * np.abs(cauto_j).max())
    np.testing.assert_allclose(kic, kic_j, rtol=0,
                               atol=1e-8 * np.abs(kic_j).max())
    np.testing.assert_allclose(prop.last_energies, prop_j.last_energies,
                               rtol=0, atol=1e-10)
    assert prop.t == pytest.approx(prop_j.t, abs=1e-12)
