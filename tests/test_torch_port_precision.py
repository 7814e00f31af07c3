# coding: utf-8
"""The port's precision modes (`--precision mixed | comp32 | f32`) against
the JAX package's, mode for mode, on the CPU.

Both packages start from the same numpy normals and propagate the same
models; JAX runs its Pallas kernels' plain references on the CPU, the port
the plain versions of K1-K5. Tolerances:

* `_comp_accumulate` and the comp32 split of `TrajState.initial`: bit for
  bit; the parameter packs: their dtypes equal and every value within one
  float32 rounding (2**-23 relative to the field's largest entry), the
  comp32 center residuals bit for bit;
* `rk4_step` over 20 steps (diagonal and dense monodromy): q (+ qc), p, S
  and the monodromy within 1e-6 of each field's largest value; the
  harmonic PES with float32 contractions within 1e-6;
* K2 and K3 at complex64 on coumarin's m = 45 leaves against LAPACK at
  1e-4 relative (the other shapes of the paths are held against the Pallas
  kernels in tests/test_torch_port_{det,gj,det_block,wm_diag}.py);
* each mode of the port against the same mode of the JAX package (HK and
  WM `propagate` on a 12-mode AS model, the CLI npz on methylium and on a
  2-mode AS model): C(t) and k~ic(t) within 2e-6 of their largest modulus
  (measured: below 1e-6 in every mode);
* the JAX package's own gates of tests/test_comp32.py and
  tests/test_precision.py, each run on both sides.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation import hk as jax_hk
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import cli, convert
from semiclassical_tpu_torch.checkpoint import (load_propagator_state,
                                                save_propagator_state)
from semiclassical_tpu_torch.config import ConfigurationError
from semiclassical_tpu_torch.ops import gj
from semiclassical_tpu_torch.potentials import (MolecularHarmonicPotential,
                                                MorsePotential)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator,
                                                 eom, hk, wm)
from semiclassical_tpu_torch.propagation.state import TrajState

# (JAX dtype, JAX traj_dtype, port dtype, port traj_dtype) of each mode
MODES = {
    "f64": (jnp.float64, jnp.float64, torch.float64, torch.float64),
    "mixed": (jnp.float32, jnp.float64, torch.float32, torch.float64),
    "comp32": (jnp.float32, "comp32", torch.float32, "comp32"),
    "f32": (jnp.float32, jnp.float32, torch.float32, torch.float32),
}
REDUCED = ("mixed", "comp32", "f32")
EXAMPLE = (pathlib.Path(__file__).resolve().parents[1] / "examples"
           / "methylium_AH" / "semi.json")
# the port against the JAX package in the same mode, of the largest modulus
SAME_MODE_TOL = 2e-6
F32_ULP = 2.0 ** -23


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


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _as12(seed=0, d=12):
    """tests/test_comp32.py's anharmonic model: (omega, chi, nac, q0)."""
    rng = np.random.default_rng(seed)
    omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
    chi = np.full(d, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    return omega, chi, nac, np.sqrt(2 * S / omega)


def _draw(n, rank, seed=11):
    return np.random.default_rng(seed + 1000 * rank + n).standard_normal(
        (n, 2 * rank))


def jax_propagator(cls, G, q0, pot_j, draw, mode, monkeypatch, *args,
                   diag=True):
    """A JAX propagator in `mode` whose batch starts at the normals `draw`
    (the state and batch constants built as its initial_conditions builds
    them from float64 samples)."""
    dtype, traj, _, _ = MODES[mode]
    n = draw.shape[0]
    sp = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method: jnp.asarray(draw))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp, None, n)
    prop = cls(G, G, *args, dtype=dtype, traj_dtype=traj)
    # what initial_conditions sets, without its own draw
    prop.sampling, prop.mesh, prop.sampling_method = sp, None, "pseudo"
    prop.params = prop._make_params(G, q0, 0 * q0, np.asarray(sp.U),
                                    np.asarray(sp.iGi0))
    prop.ntraj, prop.t = n, 0.0
    prop._integ_invalidate()
    comp = traj == "comp32"
    prop.state = JaxTrajState.initial(qi, pi, dtype=None if comp else traj,
                                      mono_dtype=dtype, diag_monodromy=diag,
                                      compensated=comp)
    prop._bc = prop._make_batch_constants(qi if comp else prop.state.q,
                                          pi if comp else prop.state.p,
                                          log_prob, pot_j)
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)
    return prop


def port_propagator(cls, G, q0, pot, draw, mode, *args):
    _, _, dtype, traj = MODES[mode]
    prop = cls(G, G, *args, device="cpu", dtype=dtype, traj_dtype=traj)
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=draw.shape[0],
                            normals=torch.from_numpy(draw))
    return prop


# --- the modules ------------------------------------------------------------

def test_comp_accumulate_bit_equal_to_jax():
    """The two-sum on the same float32 inputs, element for element."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * 10.0).astype(np.float32)
    c = (rng.standard_normal(4096) * 1e-6).astype(np.float32)
    inc = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
    t, r = eom._comp_accumulate(*map(torch.from_numpy, (x, c, inc)))
    tj, rj = jax_eom._comp_accumulate(*map(jnp.asarray, (x, c, inc)))
    assert t.dtype == r.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(r.numpy(), np.asarray(rj))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_comp_accumulate_tracks_f64(side):
    """tests/test_comp32.py's gate, on both sides: 10k small float32
    increments accumulate to 1e-9 of the float64 sum, the plain float32
    sum 100x worse."""
    incs = np.random.default_rng(3).standard_normal(10000).astype(
        np.float32) * 1e-3
    if side == "port":
        xs = torch.ones(1, dtype=torch.float32)
        cs = torch.zeros(1, dtype=torch.float32)
        plain = torch.ones(1, dtype=torch.float32)
        for inc in torch.from_numpy(incs)[:, None]:
            xs, cs = eom._comp_accumulate(xs, cs, inc)
            plain = plain + inc
        total, plain = float(xs) + float(cs), float(plain)
    else:
        def body(carry, inc):
            (x, c), p = carry
            return (jax_eom._comp_accumulate(x, c, inc), p + inc), None
        ((x, c), p), _ = jax.lax.scan(
            body, ((jnp.float32(1.0), jnp.float32(0.0)), jnp.float32(1.0)),
            jnp.asarray(incs))
        total, plain = float(x) + float(c), float(p)
    exact = 1.0 + np.sum(incs.astype(np.float64))
    assert abs(total - exact) < 1e-9
    assert abs(plain - exact) > 100 * max(abs(total - exact), 1e-12)


def test_comp32_split_bit_equal_to_jax():
    rng = np.random.default_rng(8)
    q, p = rng.standard_normal((2, 50, 6)) * 3.0
    st = TrajState.initial(torch.from_numpy(q), torch.from_numpy(p),
                           mono_dtype=torch.float32, diag_monodromy=True,
                           compensated=True)
    st_j = JaxTrajState.initial(jnp.asarray(q), jnp.asarray(p),
                                mono_dtype=jnp.float32, diag_monodromy=True,
                                compensated=True)
    for name in ("q", "qc", "p", "pc"):
        got, ref = getattr(st, name), np.asarray(getattr(st_j, name))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert st.S.dtype == torch.float64 and st.Z.dtype == torch.float32
    assert st.compensated and not TrajState.initial(
        torch.from_numpy(q), torch.from_numpy(p)).compensated


def _check_pack(port, ref, path=""):
    """Every tensor field of two packs: the same dtype, values within one
    float32 rounding of the field's largest entry."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _check_pack(a, b, f"{path}{f.name}.")
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f"{path}{f.name}"
            scale = float(b.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= 2 * F32_ULP * scale, \
                f"{path}{f.name}"
        else:
            assert (a is None) == (b is None), f"{path}{f.name}"


@pytest.mark.parametrize("mode", REDUCED)
@pytest.mark.parametrize("widths", ["diagonal", "dense"])
def test_parameter_packs_match_jax(mode, widths):
    """`build_hk_params` and `_build_wm_params` in each mode against the
    JAX package's packs carried across: dtypes, values, the residuals."""
    d = 6
    omega, _, _, q0 = _as12(d=d)
    G = np.diag(omega)
    if widths == "dense":
        Q, _ = np.linalg.qr(np.random.default_rng(2).standard_normal((d, d)))
        G = Q @ G @ Q.T
    jd, jt, td, tt = MODES[mode]
    sp = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    U, iGi0 = np.asarray(sp.U), np.asarray(sp.iGi0)
    pj = jax_hk._build_hk_params(G, G, G, q0, 0 * q0, U, iGi0, jd,
                                 traj_dtype=jt)
    port = hk.build_hk_params(G, G, G, q0, 0 * q0, U, iGi0, "cpu", td, tt)
    _check_pack(port, convert.hk_params(_fields(pj), "cpu"))
    assert port.dtype == torch.float32
    assert port.q0.dtype == (torch.float64 if mode == "mixed"
                             else torch.float32)
    if mode == "comp32":
        np.testing.assert_array_equal(port.q0c.numpy(), np.asarray(pj.q0c))
        np.testing.assert_array_equal(port.p0c.numpy(), np.asarray(pj.p0c))
        # the split center is the float64 one to float32 squared
        assert np.abs(port.q0.double().numpy() + port.q0c.double().numpy()
                      - q0).max() <= 1e-12 * np.abs(q0).max()
    else:
        assert port.q0c is None
    wj = jax_wm._build_wm_params(pj, G, G, G, 500.0, 500.0, jd)
    wport = wm._build_wm_params(port, G, G, G, U, iGi0, 500.0, 500.0, "cpu",
                                td)
    wref = convert.wm_params(_fields(wj), "cpu")
    assert wport.scan_diag == wref.scan_diag == (widths == "diagonal")
    _check_pack(wport, wref)
    assert wport.cdtype == torch.complex64


def _harmonic(d=12, seed=4):
    """A synthetic molecular harmonic PES (both packages' fields)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, d))
    hess = 0.05 * (X @ X.T / d + np.eye(d))
    f = dict(pos0=rng.standard_normal(d) * 2.0, energy0=-77.3,
             grad0=0.01 * rng.standard_normal(d), hess0=hess,
             nac0=rng.standard_normal(d),
             mass=rng.uniform(1800.0, 20000.0, d), origin=-77.31)
    return f


def _harmonic_pair(contract):
    f = _harmonic()
    pot = MolecularHarmonicPotential.from_arrays(
        **f, device="cpu", contract_dtype=torch.float32 if contract else None)
    pot_j = jax_potentials.MolecularHarmonicPotential(
        **{k: jnp.asarray(v) for k, v in f.items()},
        contract_dtype="float32" if contract else "")
    return pot, pot_j, f


@pytest.mark.parametrize("qdtype", ["float64", "float32"])
def test_harmonic_contract_dtype_matches_jax(qdtype):
    pot, pot_j, f = _harmonic_pair(contract=True)
    assert convert.molecular_harmonic_potential(
        _fields(pot_j), "cpu").contract_dtype == torch.float32
    q = (f["pos0"][None] + 0.1 * np.random.default_rng(1).standard_normal(
        (30, 12))).astype(qdtype)
    v, g, H = pot.local_expansion(torch.from_numpy(q))
    vj, gj_, Hj = pot_j.local_expansion(jnp.asarray(q))
    assert H.mat.dtype == torch.float32 and g.dtype == getattr(torch, qdtype)
    assert v.dtype == torch.float64
    for got, ref in ((v, vj), (g, gj_), (H.mat, Hj.mat)):
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-6


def _morse_pair(mode, d=6):
    omega, chi, nac, q0 = _as12(d=d)
    dtype = MODES[mode][2]
    return (MorsePotential.create(omega, chi, nac, device="cpu", dtype=dtype),
            jax_potentials.MorsePotential.create(omega, chi, nac,
                                                 dtype=MODES[mode][0]), q0)


def _check_state(st, st_j, tol=1e-6):
    q, p = st.q.double(), st.p.double()
    qj, pj = np.asarray(st_j.q, np.float64), np.asarray(st_j.p, np.float64)
    if st.compensated:
        q, p = q + st.qc.double(), p + st.pc.double()
        qj = qj + np.asarray(st_j.qc, np.float64)
        pj = pj + np.asarray(st_j.pc, np.float64)
    Zj = convert.traj_state(_fields(st_j), "cpu").Z
    assert st.Z.dtype == Zj.dtype
    for got, ref in ((q, qj), (p, pj), (st.S, st_j.S), (st.Z, Zj)):
        assert _rel(got.double().numpy(), np.asarray(ref, np.float64)) <= tol


@pytest.mark.parametrize("mode", ["mixed", "comp32"])
@pytest.mark.parametrize("mono", ["diagonal", "dense"])
def test_rk4_step_matches_jax(mode, mono):
    """20 RK4 steps of the same state in both packages: the separable Morse
    PES (diagonal monodromy, float32 parameters) or the harmonic molecular
    PES with float32 contractions (dense monodromy, the constant step
    map)."""
    rng = np.random.default_rng(9)
    comp = mode == "comp32"
    if mono == "diagonal":
        pot, pot_j, q0 = _morse_pair(mode)
        q = q0[None] + 0.3 * rng.standard_normal((40, 6))
        p = 0.01 * rng.standard_normal((40, 6))
        dt = 2.0
    else:
        pot, pot_j, f = _harmonic_pair(contract=True)
        q = f["pos0"][None] + 0.2 * rng.standard_normal((40, 12))
        p = 2.0 * rng.standard_normal((40, 12))
        dt = 5.0
    diag = mono == "diagonal"
    kw = dict(mono_dtype=torch.float32, diag_monodromy=diag, compensated=comp)
    st = TrajState.initial(torch.from_numpy(q), torch.from_numpy(p),
                           dtype=None if comp else torch.float64, **kw)
    st_j = JaxTrajState.initial(jnp.asarray(q), jnp.asarray(p),
                                dtype=None if comp else jnp.float64,
                                mono_dtype=jnp.float32, diag_monodromy=diag,
                                compensated=comp)
    step_j = jax.jit(lambda s: jax_eom.rk4_step(s, pot_j, dt))
    for _ in range(20):
        st, e = eom.rk4_step(st, pot, dt)
        st_j, e_j = step_j(st_j)
    assert st.Z.dtype == torch.float32
    assert st.q.dtype == (torch.float32 if comp else torch.float64)
    assert abs(float(e) - float(e_j)) <= 1e-6 * abs(float(e_j))
    _check_state(st, st_j)


def _leaf(rng, n, m):
    return (np.eye(m)[None] + 0.3 * (rng.standard_normal((n, m, m)) + 1j
                                     * rng.standard_normal((n, m, m)))
            / np.sqrt(m)).astype(np.complex64)


@pytest.mark.parametrize("k", [90, 45, 5, 0])
def test_gj_c64_at_the_coumarin_leaves(k):
    """K2's plain version at complex64 on coumarin's three m = 45 leaves
    (k = 90, 45, 5) and K3's on its A-matrix leaf (k = 0) against LAPACK at
    complex128. The Pallas kernels' interpret mode takes 8-13 s a leaf on
    the CPU; their complex64 comparison is in tests/test_torch_port_gj.py
    at m = 6 and 12, and tests/test_torch_port_det_block.py holds K4 at
    m = 45."""
    rng = np.random.default_rng(45 + k)
    A = _leaf(rng, 12, 45)
    A64 = A.astype(np.complex128)
    if k == 0:
        det, inv = gj.batched_det_inv_gj_plain(torch.from_numpy(A))
        assert det.dtype == inv.dtype == torch.complex64
        assert _rel(inv.numpy(), np.linalg.inv(A64)) < 1e-4
    else:
        B = (rng.standard_normal((12, 45, k))
             + 1j * rng.standard_normal((12, 45, k))).astype(np.complex64)
        det, sol = gj.batched_det_solve_gj_plain(torch.from_numpy(A),
                                                 torch.from_numpy(B))
        assert det.dtype == sol.dtype == torch.complex64
        assert _rel(sol.numpy(),
                    np.linalg.solve(A64, B.astype(np.complex128))) < 1e-4
    assert _rel(det.numpy(), np.linalg.det(A64)) < 1e-4


# --- propagate, mode for mode, and the JAX package's gates ----------------

NTRAJ_AS, NSTEPS_AS, DT_AS = 256, 100, 2.0


@pytest.fixture(scope="module")
def as12_runs():
    """HK and WM (alpha = beta = 500) on tests/test_precision.py's 12-mode
    model, 256 trajectories x 100 steps of 2 a.u., in every mode, in both
    packages from the same normals: {(prop, mode): (port (C, k), JAX (C,
    k), port propagator)}."""
    omega, chi, nac, q0 = _as12()
    G = np.diag(omega)
    draw = _draw(NTRAJ_AS, 12)
    en0 = float(omega.sum() / 2)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, cls_j, cls, args in (("HK", JaxHK, HermanKlukPropagator,
                                        ()),
                                       ("WM", JaxWM,
                                        WaltonManolopoulosPropagator,
                                        (500.0, 500.0))):
            for mode in MODES:
                pot = MorsePotential.create(omega, chi, nac, device="cpu",
                                            dtype=MODES[mode][2])
                pot_j = jax_potentials.MorsePotential.create(
                    omega, chi, nac, dtype=MODES[mode][0])
                pj = jax_propagator(cls_j, G, q0, pot_j, draw, mode, mp,
                                    *args)
                ref = pj.propagate(pot_j, DT_AS, NSTEPS_AS, energy0_es=en0,
                                   check_energy=False)
                pp = port_propagator(cls, G, q0, pot, draw, mode, *args)
                got = pp.propagate(pot, DT_AS, NSTEPS_AS, energy0_es=en0,
                                   check_energy=False)
                out[name, mode] = (got, ref, pp)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", REDUCED)
@pytest.mark.parametrize("name", ["HK", "WM"])
def test_propagate_matches_jax_mode_for_mode(as12_runs, name, mode):
    (c, k), (cj, kj), prop = as12_runs[name, mode]
    st = prop.state
    assert st.Z.dtype == torch.float32 and prop.cdtype == torch.complex64
    assert st.q.dtype == (torch.float64 if mode == "mixed" else
                          torch.float32)
    assert st.S.dtype == (torch.float32 if mode == "f32" else torch.float64)
    assert st.compensated == (mode == "comp32")
    assert _rel(c, cj) <= SAME_MODE_TOL and _rel(k, kj) <= SAME_MODE_TOL


@pytest.mark.parametrize("side", [0, 1], ids=["port", "jax"])
@pytest.mark.parametrize("name", ["HK", "WM"])
def test_reduced_modes_track_f64(as12_runs, name, side):
    """tests/test_precision.py's gates (f32: 5e-2 / 1e-1; mixed: 1e-4 /
    1e-3 against f64) and tests/test_comp32.py's (comp32 against mixed:
    5e-4 / 5e-4), on both sides."""
    run = lambda mode: as12_runs[name, mode][side]
    (c64, k64), (cm, km) = run("f64"), run("mixed")
    (c32, k32), (cc, kc) = run("f32"), run("comp32")
    assert _rel(c32, c64) < 5e-2 and _rel(k32, k64) < 1e-1
    assert _rel(cm, c64) < 1e-4 and _rel(km, k64) < 1e-3
    assert _rel(cc, cm) < 5e-4 and _rel(kc, km) < 5e-4


def test_comp32_residuals_bounded(as12_runs):
    """The residuals stay below one ulp of the value they compensate and
    do real work (tests/test_comp32.py)."""
    st = as12_runs["HK", "comp32"][2].state
    q, qc = st.q.double().numpy(), st.qc.double().numpy()
    assert (np.abs(qc) <= F32_ULP * np.maximum(np.abs(q), 1e-3)
            + 1e-12).all()
    assert (qc != 0.0).mean() > 0.5


@pytest.mark.parametrize("pes", ["morse", "harmonic"])
def test_exact_runs_under_mixed(pes):
    """`integrator: "exact"` under mixed (float64 trajectories): the Morse
    map (its planes cast to float32) and the harmonic map (increments and
    T @ Z at float32) against RK4 at the same mode and draws, within the
    float32 algebra's 1e-5 over 50 steps."""
    if pes == "morse":
        pot, _, q0 = _morse_pair("mixed")
        omega = _as12(d=6)[0]
        G, dt = np.diag(omega), 2.0
    else:
        pot, _, f = _harmonic_pair(contract=True)
        q0 = f["pos0"]
        G, dt = np.diag(np.sqrt(np.diag(f["hess0"]) * f["mass"])), 5.0
    draw = _draw(64, q0.size)
    out = {}
    for integrator in ("rk4", "exact"):
        prop = HermanKlukPropagator(G, G, "cpu", integrator=integrator,
                                    dtype=torch.float32,
                                    traj_dtype=torch.float64)
        prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=64,
                                normals=torch.from_numpy(draw))
        out[integrator] = prop.propagate(pot, dt, 50, chunk=20,
                                         check_energy=False)
        assert prop.state.Z.dtype == torch.float32
        assert prop.state.q.dtype == torch.float64
    for got, ref in zip(out["exact"], out["rk4"]):
        assert _rel(got, ref) < 1e-5


def test_comp32_requires_float32():
    """comp32 trajectories need the float32 algebra; with it the exact
    integrator runs on them (the Morse map at float32, S at float64)."""
    with pytest.raises(ValueError, match="comp32 trajectories require"):
        HermanKlukPropagator(np.eye(2), np.eye(2), "cpu",
                             dtype=torch.float64, traj_dtype="comp32")
    pot, _, q0 = _morse_pair("comp32", d=2)
    G = np.diag(_as12(d=2)[0])
    prop = HermanKlukPropagator(G, G, "cpu", integrator="exact",
                                dtype=torch.float32, traj_dtype="comp32")
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=16,
                            normals=torch.from_numpy(_draw(16, 2)))
    cauto, _ = prop.propagate(pot, DT_AS, 5)
    assert np.isfinite(cauto).all() and abs(cauto[0] - 1.0) < 1e-2
    assert prop.state.q.dtype == torch.float32 and prop.state.compensated
    assert prop.state.S.dtype == torch.float64


def test_comp32_checkpoint_roundtrip(tmp_path):
    """A comp32 checkpoint (float32 state, residuals, float64 S) restores
    bit for bit and the resumed run equals the uninterrupted one; resumed
    under another mode it raises naming the key."""
    omega, chi, nac, q0 = _as12()
    G = np.diag(omega)
    pot = MorsePotential.create(omega, chi, nac, device="cpu",
                                dtype=torch.float32)
    draw = _draw(64, 12)
    full = port_propagator(HermanKlukPropagator, G, q0, pot, draw, "comp32")
    c_full, _ = full.propagate(pot, DT_AS, 20, check_energy=False)
    head = port_propagator(HermanKlukPropagator, G, q0, pot, draw, "comp32")
    c_head, _ = head.propagate(pot, DT_AS, 10, check_energy=False)
    fn = str(tmp_path / "ck.npz")
    save_propagator_state(fn, head)
    data = np.load(fn)
    assert data["state/qc"].dtype == np.float32
    assert data["state/S"].dtype == np.float64
    assert "params/q0c" in data.files
    tail = port_propagator(HermanKlukPropagator, G, q0, pot, draw, "comp32")
    load_propagator_state(fn, tail)
    np.testing.assert_array_equal(tail.state.qc.numpy(),
                                  head.state.qc.numpy())
    c_tail, _ = tail.propagate(pot, DT_AS, 10, check_energy=False)
    np.testing.assert_allclose(np.concatenate([c_head, c_tail]), c_full,
                               rtol=0, atol=1e-12)
    mixed = port_propagator(HermanKlukPropagator, G, q0, pot, draw, "mixed")
    with pytest.raises(ValueError, match="'params/q0c'"):
        load_propagator_state(fn, mixed)
    f32 = port_propagator(HermanKlukPropagator, G, q0, pot, draw, "f32")
    with pytest.raises(ValueError, match="'params/q0c'"):
        load_propagator_state(fn, f32)
    save_propagator_state(fn, mixed)
    with pytest.raises(ValueError, match="'state/q'.*float64"):
        load_propagator_state(fn, f32)


@pytest.fixture(scope="module")
def wm60_runs():
    """tests/test_precision.py's 60-mode WM model (cell 1e4), 128
    trajectories x 5 steps of 0.25 a.u. at mixed and f64, in both packages
    from the same normals: {mode: {"port": propagator, "jax": propagator,
    side: (C, k)}}."""
    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    dQ = np.sqrt(2.0 * S / omega)
    G = np.diag(omega)
    draw = _draw(128, d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac, device="cpu")
    pot_j = jax_potentials.MorsePotential.create(omega, np.full(d, 0.02),
                                                 nac)
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        for mode in ("mixed", "f64"):
            pp = port_propagator(WaltonManolopoulosPropagator, G, dQ, pot,
                                 draw, mode, 1e4, 1e4)
            pj = jax_propagator(JaxWM, G, dQ, pot_j, draw, mode, mp, 1e4,
                                1e4)
            runs[mode] = {"port": pp, "jax": pj, "x": dQ[None, :]
                          * np.linspace(0.0, 1.2, 5)[:, None]}
            for side, prop, p in (("port", pp, pot), ("jax", pj, pot_j)):
                runs[mode][side, "C"] = tuple(np.asarray(x) for x in
                                              prop.propagate(
                                                  p, 0.25, 5,
                                                  check_energy=False))
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("side", ["port", "jax"])
def test_wm_mixed_many_modes(wm60_runs, side):
    """tests/test_precision.py's 60-mode WM regression, on both sides: the
    scaled detM keeps the mixed observables finite and within 1e-3 of f64;
    the port's mixed run equals the JAX package's."""
    cm, km = wm60_runs["mixed"][side, "C"]
    c64, _ = wm60_runs["f64"][side, "C"]
    assert np.isfinite(cm).all() and np.isfinite(km).all()
    assert abs(cm[0] - 1.0) < 1e-2
    assert np.abs(cm - c64).max() < 1e-3 * np.abs(c64).max()
    assert _rel(wm60_runs["mixed"]["port", "C"][0],
                wm60_runs["mixed"]["jax", "C"][0]) <= SAME_MODE_TOL


def _diagnostics(runs, mode, side):
    """(log-coefficients, grid wavefunction, the derived tensors or None)
    of one run, computed once."""
    key = (side, "diag")
    if key not in runs[mode]:
        prop, x = runs[mode][side], runs[mode]["x"]
        if side == "port":
            log_v, derived = prop._log_coefficients_and_derived()
            psi, zmax = wm.wm_wavefunction(
                prop.params, prop.bc, prop.state, derived, log_v,
                torch.from_numpy(x))
            runs[mode][key] = (tuple(v.numpy() for v in log_v),
                               psi.numpy().astype(np.complex128)
                               * np.exp(zmax.numpy().astype(np.float64)),
                               (log_v, derived))
        else:
            runs[mode][key] = (prop.log_coefficients(),
                               prop.wavefunction(jnp.asarray(x)), None)
    return runs[mode][key]


def test_wm_diagnostics_many_modes_mixed(wm60_runs):
    """tests/test_precision.py's WM diagnostics at 60 modes in mixed
    precision (log-coefficients and the grid wavefunction within its gates
    of the f64 evaluation; the port's mixed values against the JAX
    package's; its own f64-side gates are its test's)."""
    (lr_m, li_m), psi_m, _ = _diagnostics(wm60_runs, "mixed", "port")
    (lr_64, li_64), psi_64, _ = _diagnostics(wm60_runs, "f64", "port")
    assert np.isfinite(lr_m).all() and np.abs(lr_m - lr_64).max() < 1e-2
    dphi = (li_m - li_64 + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(dphi).max() < 1e-2
    assert np.isfinite(psi_m).all()
    assert np.abs(psi_m - psi_64).max() < 2e-3 * np.abs(psi_64).max()
    # the linear scale underflows float32 here
    assert 2.0 * lr_64.max() < np.log(1e-38)
    (lr_j, _), psi_j, _ = _diagnostics(wm60_runs, "mixed", "jax")
    assert np.abs(lr_m - np.asarray(lr_j)).max() < 1e-4
    assert _rel(psi_m, psi_j) < 1e-4


def test_wm_norm_many_modes_mixed(wm60_runs):
    """The WM norm at 60 modes in mixed precision (K3 at complex64 on the
    pair blocks) within tests/test_precision.py's 2e-3 of f64, over the
    pairs of the first 16 trajectories."""
    norms = {}
    for mode in ("mixed", "f64"):
        prop = wm60_runs[mode]["port"]
        log_v, derived = _diagnostics(wm60_runs, mode, "port")[2]
        rows = lambda x: hk._batch_rows(x, 0, 16)
        norms[mode] = wm.wm_norm(prop.params, rows(prop.bc),
                                 rows(prop.state), rows(derived),
                                 tuple(x[:16] for x in log_v), block=16)
    assert np.isfinite(norms["f64"]) and norms["f64"] > 0.0
    assert abs(norms["mixed"] - norms["f64"]) < 2e-3 * norms["f64"]


# --- the CLI, mode for mode ---------------------------------------------

@pytest.fixture()
def methylium_task(ref_data):
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")
    with open(EXAMPLE) as f:
        task = json.load(f)["semi"][0]
    task["potential"].update(ground=str(base / "opt_freq_s0.fchk"),
                             excited=str(base / "opt_freq_s1.fchk"),
                             coupling=str(base / "opt_freq_s1.fchk"))
    task.update(num_trajectories=32, batch_size=32, num_steps=20,
                manual_seed=5)
    return task


def _cli_pair(task, precision, tmp_path, monkeypatch, rank):
    """The npz of both CLIs' dynamics for `task` at `precision`, each from
    the same normals."""
    draw = _draw(task["batch_size"], rank)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method: jnp.asarray(draw))
    sample = hk.sample_initial_conditions
    monkeypatch.setattr(hk, "sample_initial_conditions",
                        lambda params, ntraj, generator=None, normals=None:
                        sample(params, ntraj, normals=torch.from_numpy(draw)))
    out = []
    for side in ("port", "jax"):
        npz = str(tmp_path / f"{side}_{task.get('propagator')}_{precision}"
                             ".npz")
        t = dict(task, results={"correlations": npz})
        if side == "port":
            cli.run_semiclassical_dynamics(t, device="cpu",
                                           precision=precision)
        else:
            jax_cli.run_semiclassical_dynamics(t, num_devices=1,
                                               precision=precision)
        out.append(dict(np.load(npz)))
    return out


@pytest.mark.parametrize("name, modes", [("HK", ("mixed", "f32")),
                                         ("WM", ("mixed", "comp32"))])
def test_cli_methylium_matches_jax(methylium_task, tmp_path, monkeypatch,
                                   caplog, name, modes):
    """Methylium (the dense, rank-deficient path: K1, and K2/K3 under WM)
    through both CLIs at 32 trajectories x 20 steps, HK at mixed and f32,
    WM at mixed and comp32: the npz keys and dtypes, C(t) and k~ic(t) mode
    for mode; the second mode against mixed on both sides (comp32 within
    tests/test_comp32.py's dense-path gate); the log line of the mode."""
    methylium_task["propagator"] = name
    runs = {}
    with caplog.at_level("INFO"):
        for mode in modes:
            runs[mode] = _cli_pair(methylium_task, mode, tmp_path,
                                   monkeypatch, rank=6)
    assert (f"  numerical precision                       : {modes[1]}"
            in [r.getMessage() for r in caplog.records])
    for mode, (got, ref) in runs.items():
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype, key
        assert abs(got["autocorrelation"][0] - 1.0) < 1e-3
        for key in ("autocorrelation", "ic_correlation"):
            assert _rel(got[key], ref[key]) <= SAME_MODE_TOL, (mode, key)
    for side in (0, 1):
        m, c = runs["mixed"][side], runs[modes[1]][side]
        # comp32: tests/test_comp32.py's dense-path gate; f32: the mixed
        # one's envelope of tests/test_precision.py
        for key, gate in (("autocorrelation", 5e-4), ("ic_correlation",
                                                       5e-4 if modes[1] ==
                                                       "comp32" else 1e-3)):
            assert _rel(c[key], m[key]) < gate


def test_cli_comp32_as_model(tmp_path, monkeypatch):
    """tests/test_comp32.py's CLI run (a 2-mode AS model, 256 trajectories
    x 20 steps, --precision comp32) through both CLIs: C(0) = 1, finite,
    and the two npz equal mode for mode."""
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    task = {"task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": "AS_model.dat"},
            "propagator": "HK", "batch_size": 256, "num_trajectories": 256,
            "num_steps": 20, "time_step_fs": 0.05}
    got, ref = _cli_pair(task, "comp32", tmp_path, monkeypatch, rank=2)
    for d in (got, ref):
        assert abs(d["autocorrelation"][0] - 1.0) < 1e-3
        assert np.isfinite(d["autocorrelation"]).all()
    for key in ("autocorrelation", "ic_correlation"):
        assert _rel(got[key], ref[key]) <= SAME_MODE_TOL, key


@pytest.mark.parametrize("argv, named", [
    (["--precision", "bf16"], "'bf16' is unknown"),
    (["--precision", "f32"], None)], ids=["bf16-refused", "f32-exact-runs"])
def test_cli_refusals(methylium_task, tmp_path, argv, named):
    """An unknown precision is refused by name before the npz is written;
    `integrator: "exact"` under f32 runs and writes it."""
    methylium_task.update(integrator="exact")
    npz = tmp_path / "c.npz"
    path = tmp_path / "semi.json"
    path.write_text(json.dumps({"semi": [dict(
        methylium_task, results={"correlations": str(npz)})]}))
    if named is None:
        assert cli.main(["dynamics", str(path), "--device", "cpu",
                         *argv]) == 0
        data = np.load(npz)
        assert np.isfinite(data["autocorrelation"]).all()
        assert abs(data["autocorrelation"][0] - 1.0) < 1e-3
        return
    with pytest.raises(ConfigurationError, match=named):
        cli.main(["dynamics", str(path), "--device", "cpu", *argv])
    assert not npz.exists()


def test_cli_gdml_warns_for_comp32(caplog, monkeypatch):
    """sGDML under comp32 or f32: the JAX package's warning, word for word
    (the run itself is stopped right after it)."""
    class Stop(Exception):
        pass

    monkeypatch.setattr(cli, "_build_potential",
                        lambda task, device: (None,) * 7)
    monkeypatch.setattr(cli, "_precision_dtypes",
                        lambda precision: (_ for _ in ()).throw(Stop()))
    task = {"task": "dynamics", "potential": {"type": "gdml"},
            "time_step_fs": 0.05, "num_steps": 2,
            "results": {"correlations": "c.npz"}}
    with caplog.at_level("WARNING"), pytest.raises(Stop):
        cli.run_semiclassical_dynamics(task, device="cpu", precision="f32")
    assert [r.getMessage() for r in caplog.records] == [
        "--precision f32 with a gdml potential is unvalidated: sGDML "
        "regression sums are cancellation-bound and were measured to need "
        "f64 energies/gradients — use 'mixed' (default) and the potential's "
        "hess_dtype keyword for the validated reduced-precision mode"]
