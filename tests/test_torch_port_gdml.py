# coding: utf-8
"""The port's sGDML slice against the JAX package, at float64 on the CPU:
`gdml_forward`, `MolecularGDMLPotential` and `minimize`, one `rk4_step` per
`hessian_eval` mode, the `taylor_every` window with its restart at each scan
segment, HK and WM `propagate` on coumarin (17 atoms, 51 coordinates, rank
45), the CLI's npz, and the first steps of the committed JAX reference
curves (tests/data/coumarin_jax_reference.npz).

Tolerances, and why:

* A synthetic two-permutation model with O(1) regression weights has no
  cancellation in its sums, so the two implementations agree to rounding:
  1e-12 relative to each output's largest entry at float64, 1e-5 for the
  float32 Hessian (`hess_dtype`).
* The coumarin model's permutation-expanded weights reach ~1e11 and its
  energy sums cancel by 1e5-1e7: any two f64 implementations that sum in
  another order differ by ~1e-8 Ha (both sit 3e-8 to 5e-8 Ha from a
  long-double oracle). There the limits are those the JAX package sets
  for two independent f64 implementations of this model
  (tests/test_gdml.py::test_against_torch_reference): 1e-6 per-sample L2
  for energies and gradients, 1e-5 for Hessians; and its mixed-mode limit
  1e-4 of the largest entry for the float32 Hessian.
* Dynamics on coumarin start both packages at the same draws and give the
  port the JAX package's energy origin (the minimum energy, itself at the
  energy floor above), so that a global phase drift does not hide the
  algebra. The two packages' energies differ by up to 2.8e-8 Ha and their
  gradients by 5.4e-9 Ha/bohr over 64 geometries near the minimum, so
  the floors are E_FLOOR = 1e-7 Ha and G_FLOOR = 1e-8 Ha/bohr: q at 1e-9,
  p at G_FLOOR and S at E_FLOOR times the elapsed time, the monodromy at
  1e-8, C(t) and k~ic(t) at 1e-6 of their largest value.
* With a float32 Hessian (`hess_dtype`) the Hessian is a noisy function of
  the geometry in both packages (rms 8e-6 of its largest entry from the
  float64 one), and trajectories that differ at the 1e-8 floor above
  draw different roundings of it. So a whole run is held at 1e-4 of the
  largest value of C(t) and k~ic(t) (measured: 2.4e-5 and 4.0e-5 after 24
  steps), and the window machinery is held tightly on one shared input:
  the JAX package's own float32 window expansion.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import cli as jax_cli
from semiclassical_tpu import gdml as jax_gdml
from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu.io.fchk import FormattedCheckpointFile as JaxFchk
from semiclassical_tpu.propagation import HermanKlukPropagator as JaxHK
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import eom as jax_eom
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu.pytree import replace as jax_replace
from semiclassical_tpu_torch import cli, convert, gdml, units
from semiclassical_tpu_torch.io.fchk import FormattedCheckpointFile
from semiclassical_tpu_torch.potentials import (MolecularGDMLPotential,
                                                minimize)
from semiclassical_tpu_torch.propagation import (HermanKlukPropagator,
                                                 WaltonManolopoulosPropagator,
                                                 eom)
from semiclassical_tpu_torch.propagation.state import TrajState

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "coumarin_gdml"
REFERENCE = ROOT / "tests" / "data" / "coumarin_jax_reference.npz"
MODEL = "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz"
NTRAJ = 8
DT = 2.0      # a.u.
CELL = 10000.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test here on one intra-op thread: the suite's worker
    processes otherwise oversubscribe the cores."""
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
        elif v is None or isinstance(v, (bool, int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def coumarin(ref_data):
    model_path = ref_data / "GDML" / MODEL
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")
    model = dict(np.load(model_path, allow_pickle=True))
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    with open(s1) as f:
        exc_j = JaxFchk(f)
    x0, G0, zpe = exc.vibrational_groundstate()
    pot = minimize(MolecularGDMLPotential.create(model, exc, "cpu"), x0)
    pot_j = jax_potentials.minimize(
        jax_potentials.MolecularGDMLPotential.create(model, exc_j),
        jnp.asarray(x0))
    rng = np.random.default_rng(17)
    normals = rng.standard_normal((NTRAJ, 90))
    r = x0[None] + 0.02 * rng.standard_normal((6, x0.size))
    return dict(model=model, exc=exc, exc_j=exc_j, x0=x0, G0=G0, zpe=zpe,
                pot=pot, pot_j=pot_j, normals=normals, r=r)


def _synthetic_model(n_atoms=5, n_train=6, seed=3):
    """A small sGDML model mapping with two permutations (identity and the
    swap of atoms 0 and 1) and O(1) regression weights."""
    rng = np.random.default_rng(seed)
    k, l = np.tril_indices(n_atoms, k=-1)
    D = k.size
    perms = np.array([np.arange(n_atoms), [1, 0, *range(2, n_atoms)]])
    pair_index = {(a, b): i for i, (a, b) in enumerate(zip(k, l))}
    tril_perms = np.array([[pair_index[(max(p[a], p[b]), min(p[a], p[b]))]
                            for a, b in zip(k, l)] for p in perms])
    tril_perms_lin = (tril_perms + np.arange(2)[:, None] * D).T.ravel()
    geoms = rng.standard_normal((n_train, n_atoms, 3)) * 1.5
    desc = 1.0 / np.linalg.norm(geoms[:, k] - geoms[:, l], axis=-1)
    model = dict(sig=2.0, c=-3.5, std=1.3, z=np.arange(1, n_atoms + 1),
                 perms=perms, tril_perms_lin=tril_perms_lin, R_desc=desc.T,
                 R_d_desc_alpha=rng.standard_normal((n_train, D)))
    r = (geoms[:2] + 0.3 * rng.standard_normal((2, n_atoms, 3))).reshape(2, -1)
    return model, r


def _check_forward(got, ref, rtol):
    for name, g, r in zip(("energy", "grad", "hess"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert np.abs(g - r).max() <= rtol * np.abs(r).max(), name


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("hess_dtype", ["float64", "float32"])
def test_forward_matches_jax_synthetic(order, hess_dtype):
    """Two permutations exercise the expansion order; no cancellation, so
    1e-12 (1e-5 for the float32 Hessian)."""
    model, r = _synthetic_model()
    pt = gdml.GDMLParams.from_npz(model, "cpu")
    pj = jax_gdml.GDMLParams.from_npz(model)
    np.testing.assert_array_equal(pt.xs_train.numpy(), np.asarray(pj.xs_train))
    np.testing.assert_array_equal(pt.Jx_alphas.numpy(),
                                  np.asarray(pj.Jx_alphas))
    hd = None if hess_dtype == "float64" else hess_dtype
    got = gdml.gdml_forward(pt, torch.from_numpy(r), order,
                            hess_dtype=hd and getattr(torch, hd))
    ref = jax_gdml.gdml_forward(pj, jnp.asarray(r), order, hess_dtype=hd)
    got = (got,) if order == 0 else got
    ref = (ref,) if order == 0 else ref
    _check_forward(got[:2], ref[:2], 1e-12)
    if order == 2:
        _check_forward(got[2:], ref[2:], 1e-12 if hd is None else 1e-5)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_forward_matches_jax_coumarin(coumarin, order):
    """The coumarin model at the JAX package's limits for two f64
    implementations (module docstring)."""
    pt = coumarin["pot"].gdml
    pj = coumarin["pot_j"].gdml
    r = coumarin["r"]
    got = gdml.gdml_forward(pt, torch.from_numpy(r), order)
    ref = jax_gdml.gdml_forward(pj, jnp.asarray(r), order)
    got = (got,) if order == 0 else got
    ref = (ref,) if order == 0 else ref
    n = r.shape[0]
    for name, g, rf, lim in zip(("energy", "grad", "hess"), got, ref,
                                (1e-6, 1e-6, 1e-5)):
        err = np.linalg.norm(g.numpy() - np.asarray(rf)) / n
        assert err < lim, (name, err)


def test_mixed_hessian_coumarin(coumarin):
    """hess_dtype float32: energies and gradients are those of the f64
    path bit for bit, the Hessian within 1e-4 of the largest entry of the
    f64 one (the JAX package's mixed-mode limit) and of JAX's float32
    Hessian."""
    pt = coumarin["pot"].gdml
    r = torch.from_numpy(coumarin["r"])
    e64, g64, h64 = gdml.gdml_forward(pt, r, 2)
    e32, g32, h32 = gdml.gdml_forward(pt, r, 2, hess_dtype=torch.float32)
    assert h32.dtype == torch.float32
    assert torch.equal(e32, e64) and torch.equal(g32, g64)
    scale = float(h64.abs().max())
    assert float((h32.double() - h64).abs().max()) < 1e-4 * scale
    hj = np.asarray(jax_gdml.gdml_forward(
        coumarin["pot_j"].gdml, jnp.asarray(coumarin["r"]), 2,
        hess_dtype=jnp.float32)[2])
    assert np.abs(h32.numpy() - hj).max() < 1e-4 * scale


def test_hessian_matches_jacfwd_of_gradient(coumarin):
    """The analytic Hessian is the forward-mode Jacobian of the analytic
    gradient (torch.func), to 1e-9 at a displaced geometry (the JAX
    package's limit for its own autodiff check)."""
    pt = coumarin["pot"].gdml
    r = torch.from_numpy(coumarin["r"][:1])
    _, _, hess = gdml.gdml_forward(pt, r, 2)
    J = torch.func.jacfwd(lambda x: gdml.gdml_forward(pt, x[None], 1)[1][0])(
        r[0])
    assert float((hess[0] - hess[0].T).abs().max()) < 1e-10
    assert float((J - hess[0]).abs().max()) < 1e-9


def test_potential_and_minimize_match_jax(coumarin):
    """`create` + `minimize`: the origin within 1e-7 Ha (the f64 floor of
    this model's energies, module docstring), the converters give the
    port's own objects, and the local expansion at the origin's floor."""
    pot, pot_j = coumarin["pot"], coumarin["pot_j"]
    assert abs(pot.origin - float(pot_j.origin)) < 1e-7
    conv = convert.molecular_gdml_potential(_fields(pot_j), "cpu")
    np.testing.assert_array_equal(conv.gdml.xs_train.numpy(),
                                  pot.gdml.xs_train.numpy())
    np.testing.assert_array_equal(conv.nac0.numpy(), pot.nac0.numpy())
    np.testing.assert_array_equal(conv.mass.numpy(), pot.mass.numpy())
    assert conv.origin == float(pot_j.origin)
    r = coumarin["r"]
    v, g, h = pot.local_expansion(torch.from_numpy(r))
    vj, gj, hj = pot_j.local_expansion(jnp.asarray(r))
    assert np.abs(v.numpy() - np.asarray(vj)).max() < 2e-7
    assert np.abs(h.dense().numpy() - np.asarray(hj.dense())).max() < 1e-5
    with pytest.raises(ValueError, match="taylor_every > 1 requires"):
        MolecularGDMLPotential.create(coumarin["model"], coumarin["exc"],
                                      "cpu", taylor_every=8)
    with pytest.raises(ValueError, match="unknown hessian_eval"):
        MolecularGDMLPotential.create(coumarin["model"], coumarin["exc"],
                                      "cpu", hessian_eval="window")
    # eg_mode "ozaki" runs the f64 contractions: the same pack
    ozaki = MolecularGDMLPotential.create(coumarin["model"], coumarin["exc"],
                                          "cpu", eg_mode="ozaki")
    assert torch.equal(ozaki.gdml.Jx_alphas, pot.gdml.Jx_alphas)
    with pytest.raises(ValueError, match="unknown eg_mode"):
        MolecularGDMLPotential.create(coumarin["model"], coumarin["exc"],
                                      "cpu", eg_mode="bf16")


def _variant(coumarin, **kw):
    """The port's and the JAX package's potentials with the same
    hessian_eval / taylor_every / hess_dtype, the port at JAX's origin."""
    hd = kw.pop("hess_dtype", None)
    pot = dataclasses.replace(coumarin["pot"],
                              origin=float(coumarin["pot_j"].origin),
                              hess_dtype=hd and getattr(torch, hd), **kw)
    pot_j = jax_replace(coumarin["pot_j"], hess_dtype=hd or "", **kw)
    return pot, pot_j


def _perturbed_state(coumarin, seed):
    rng = np.random.default_rng(seed)
    x0 = coumarin["x0"]
    q = x0[None] + 0.02 * rng.standard_normal((4, x0.size))
    p = 0.5 * rng.standard_normal((4, x0.size))
    Z = np.eye(2 * x0.size)[None] + 0.01 * rng.standard_normal(
        (4, 2 * x0.size, 2 * x0.size))
    d = x0.size
    st = TrajState(q=torch.from_numpy(q), p=torch.from_numpy(p),
                   Z=torch.from_numpy(Z), S=torch.zeros(4, dtype=torch.float64))
    st_j = JaxTrajState(q=jnp.asarray(q), p=jnp.asarray(p), S=jnp.zeros(4),
                        Mqq=jnp.asarray(Z[:, :d, :d]), Mqp=jnp.asarray(Z[:, :d, d:]),
                        Mpq=jnp.asarray(Z[:, d:, :d]), Mpp=jnp.asarray(Z[:, d:, d:]))
    return st, st_j


# the floors of two f64 implementations of the coumarin model (module
# docstring): energy (Ha) and gradient (Ha/bohr)
E_FLOOR = 1e-7
G_FLOOR = 1e-8


def _check_state(st, st_j, elapsed=DT):
    """q and Z relative to max(1, largest entry); p and S absolute, the
    gradient and energy floors times the elapsed time."""
    mine = convert.traj_state(_fields(st_j), "cpu")
    for name, tol in (("q", 1e-9), ("Z", 1e-8)):
        g, r = getattr(st, name).numpy(), getattr(mine, name).numpy()
        assert np.abs(g - r).max() <= tol * max(1.0, np.abs(r).max()), name
    assert float((st.p - mine.p).abs().max()) <= G_FLOOR * elapsed, "p"
    assert float((st.S - mine.S).abs().max()) <= E_FLOOR * elapsed, "S"


@pytest.mark.parametrize("mode", ["stage", "step", "taylor"])
def test_rk4_step_matches_jax(coumarin, mode):
    """One RK4 step per hessian_eval mode from a perturbed state with a
    non-trivial monodromy: the 4-stage dense chain, the frozen-Hessian
    Horner, the per-step taylor expansion."""
    pot, pot_j = _variant(coumarin, hessian_eval=mode)
    st, st_j = _perturbed_state(coumarin, seed=5)
    new, e = eom.rk4_step(st, pot, DT)
    new_j, e_j = jax_eom.rk4_step(st_j, pot_j, DT)
    _check_state(new, new_j)
    assert abs(float(e) - float(e_j)) < 1e-7


@pytest.mark.parametrize("hess_dtype", ["float64", "float32"])
def test_window_step_matches_jax(coumarin, hess_dtype):
    """The taylor_every window: the window's expansion and its per-window
    map Tmono against JAX's, then the window steps from the same state.
    float64: 12 steps of both packages (an expansion at steps 0 and 8).
    float32: the port's Hessian within the mixed-mode limit of JAX's, and
    8 steps of the port on JAX's own float32 window (converted), which
    holds the casts of the taylor corrections and the map."""
    hd = None if hess_dtype == "float64" else hess_dtype
    pot, pot_j = _variant(coumarin, hessian_eval="taylor", taylor_every=8,
                          hess_dtype=hd)
    st, st_j = _perturbed_state(coumarin, seed=6)
    carry0, step = eom.make_taylor_window(pot, DT, 8)
    carry0_j, step_j = jax_eom.make_taylor_window(pot_j, DT, 8)
    sc, sc_j = carry0(st), carry0_j(st_j)
    quad = convert.local_quadratic(_fields(sc_j[0]), "cpu")
    assert sc[0].H.dtype == quad.H.dtype == getattr(torch, hess_dtype)
    assert sc[0].Tmono.dtype == quad.Tmono.dtype == torch.float64
    h_scale = float(quad.H.abs().max())
    own_map = eom._window_mono_map(quad.H, 1.0 / pot.masses(), DT,
                                   torch.float64)
    assert float((own_map - quad.Tmono).abs().max()) < 1e-12
    if hd is None:
        assert float((sc[0].H - quad.H).abs().max()) < 1e-8 * h_scale
        assert float((sc[0].Tmono - quad.Tmono).abs().max()) < 1e-8
        nsteps = 12
    else:
        assert float((sc[0].H - quad.H).abs().max()) < 1e-4 * h_scale
        sc = (quad, 0)
        nsteps = 8
    for _ in range(nsteps):
        st, e, sc = step(st, sc)
        st_j, e_j, sc_j = step_j(st_j, sc_j)
        assert abs(float(e) - float(e_j)) < 1e-7
    assert sc[1] == int(sc_j[1]) == nsteps
    _check_state(st, st_j, elapsed=nsteps * DT)


def _jax_propagator(cls, coumarin, pot_j, monkeypatch, *args):
    """A JAX propagator whose batch starts at the injected draws."""
    x0, G0 = coumarin["x0"], coumarin["G0"]
    sp = jax_sampling.SamplingParams.create(x0, np.zeros_like(x0), G0, G0)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method:
                        jnp.asarray(coumarin["normals"]))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp, None, NTRAJ)
    prop = cls(G0, G0, *args)
    prop.initial_conditions(x0, np.zeros_like(x0), G0, ntraj=NTRAJ, key=0,
                            potential=pot_j)
    prop.state = JaxTrajState.initial(qi, pi)
    prop._bc = prop._make_batch_constants(qi, pi, log_prob, pot_j)
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)
    return prop


@pytest.mark.parametrize("propagator, mode", [
    ("HK", "taylor8"), ("WM", "taylor8"), ("HK", "step"),
    ("HK", "taylor8-float32")])
def test_propagate_matches_jax(coumarin, monkeypatch, propagator, mode):
    """8 trajectories x 24 steps in segments of 10 (chunk): a taylor_every
    8 window restarts at steps 10 and 20, as in the JAX package. A float32
    Hessian is held at its own limit (module docstring)."""
    kw = ({"hessian_eval": "taylor", "taylor_every": 8}
          if mode.startswith("taylor") else {"hessian_eval": mode})
    f32 = mode.endswith("float32")
    if f32:
        kw["hess_dtype"] = "float32"
    pot, pot_j = _variant(coumarin, **kw)
    cls_j, cls, args = {"HK": (JaxHK, HermanKlukPropagator, ()),
                        "WM": (JaxWM, WaltonManolopoulosPropagator,
                               (CELL, CELL))}[propagator]
    prop_j = _jax_propagator(cls_j, coumarin, pot_j, monkeypatch, *args)
    prop = cls(coumarin["G0"], coumarin["G0"], *args, device="cpu")
    prop.initial_conditions(coumarin["x0"], np.zeros_like(coumarin["x0"]),
                            coumarin["G0"], pot, ntraj=NTRAJ,
                            normals=torch.from_numpy(coumarin["normals"]))
    cauto_j, kic_j = prop_j.propagate(pot_j, DT, 24, energy0_es=coumarin["zpe"],
                                      chunk=10)
    cauto, kic = prop.propagate(pot, DT, 24, energy0_es=coumarin["zpe"],
                                chunk=10)
    lim = 1e-4 if f32 else 1e-6
    for got, ref in ((cauto, cauto_j), (kic, kic_j)):
        assert np.abs(got - ref).max() <= lim * np.abs(ref).max()
    if not f32:
        _check_state(prop.state, prop_j.state, elapsed=24 * DT)


def test_cli_npz_matches_jax(ref_data, tmp_path):
    """examples/coumarin_gdml/semi.json shrunk to 8 trajectories x 12 steps
    (float32 Hessian, taylor_every 8, the default scan_chunk of 500) through
    both CLIs at f64 on the CPU: the same npz keys, shapes and dtypes, the
    adiabatic gap at the energy floor, C(t) and k~ic(t) within 1e-5 of
    their largest value (each CLI draws its own trajectories from the
    seed, so only C(0) = 1 and the grids are shared exactly)."""
    if not (ref_data / "GDML" / MODEL).exists():
        pytest.skip("coumarin fixtures not available")
    with open(EXAMPLE / "semi.json") as f:
        cfg = json.load(f)
    npz = str(tmp_path / "port.npz")
    dyn, rates = cfg["semi"]
    for key, name in (("ground", "GDML/" + MODEL),
                      ("excited", "Gaussian16/coumarin_s1.fchk"),
                      ("coupling", "Gaussian16/coumarin_s1.fchk")):
        dyn["potential"][key] = str(ref_data / name)
    dyn.update(num_trajectories=8, batch_size=8, num_steps=12, manual_seed=3)
    dyn["results"]["correlations"] = npz
    rates.update(correlations=npz, rates=npz)
    path = tmp_path / "semi.json"
    path.write_text(json.dumps(cfg))
    assert cli.main(["dynamics", str(path), "--device", "cpu"]) == 0
    assert cli.main(["rates", str(path)]) == 0
    data = dict(np.load(npz))

    jnpz = str(tmp_path / "jax.npz")
    jax_cli.run_semiclassical_dynamics(
        dict(dyn, results={"correlations": jnpz}), num_devices=1,
        precision="f64")
    jax_cli.calculate_rates(dict(rates, correlations=jnpz, rates=jnpz))
    ref = dict(np.load(jnpz))
    assert sorted(data) == sorted(ref)
    for key in ref:
        assert data[key].shape == ref[key].shape, key
        assert data[key].dtype == ref[key].dtype, key
    np.testing.assert_array_equal(data["times"], ref["times"])
    np.testing.assert_array_equal(data["energies"], ref["energies"])
    assert abs(float(data["adiabatic_gap"]) - float(ref["adiabatic_gap"])) < 1e-7
    assert abs(data["autocorrelation"][0] - 1.0) < 1e-3
    assert np.isfinite(data["ic_rate"]).all()


def test_reference_file_first_steps(coumarin):
    """The committed JAX reference normals through the port on the CPU,
    HK at the example's configuration with an f64 Hessian, 20 steps: C(t)
    and k~ic(t) within 1e-6 of the file's largest value (the card is held
    to the whole 2000 steps by chip_smoke.py)."""
    ref = np.load(REFERENCE)
    ntraj, nt = int(ref["ntraj"]), 20
    with open(EXAMPLE / "semi.json") as f:
        dyn = json.load(f)["semi"][0]
    pot = dataclasses.replace(
        coumarin["pot"], origin=float(ref["origin"]), hessian_eval="taylor",
        taylor_every=int(ref["taylor_every"]))
    dt = dyn["time_step_fs"] / units.autime_to_fs
    prop = HermanKlukPropagator(coumarin["G0"], coumarin["G0"], device="cpu")
    prop.initial_conditions(coumarin["x0"], np.zeros_like(coumarin["x0"]),
                            coumarin["G0"], pot, ntraj=ntraj,
                            normals=torch.from_numpy(ref["normals"]))
    cauto, kic = prop.propagate(pot, dt, nt, energy0_es=coumarin["zpe"],
                                chunk=int(ref["chunk"]))
    for got, name in ((cauto, "cauto_hk"), (kic, "kic_hk")):
        want = ref[name]
        assert np.abs(got - want[:nt]).max() <= 1e-6 * np.abs(want).max(), name
