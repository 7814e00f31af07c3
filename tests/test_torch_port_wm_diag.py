# coding: utf-8
"""The port's separable WM path and the plain version of K5 (the fused WM
diag chain, `ops.wm_diag`) against the JAX package, on the CPU.

* K5's plain version in float32 against the Pallas kernel
  `pallas_wm_diag_derived` in interpret mode (as tests/test_ops.py runs
  it) on a padded n = 300, d = 12 batch: every output row at 1e-5 of its
  largest entry;
* in float64, the port's separable `wm_scan_derived` (K5's plain version
  on the CPU) against the JAX package's unfused chain, every field at
  1e-12; `WMDiagConsts`, the WM packs and `_wm_diag_core` at 1e-12;
* the port's separable path against its own dense path on the same state
  at 1e-10 (as tests/test_wm_fastpath.py::test_diag_path_matches_generic);
* WM `propagate` on the 5-mode AS model against the JAX package: C(t) and
  k~ic(t) at 1e-8 of their largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semiclassical_tpu import potentials as jax_potentials
from semiclassical_tpu import sampling as jax_sampling
from semiclassical_tpu import units
from semiclassical_tpu.ops import wm_kernel
from semiclassical_tpu.propagation import WaltonManolopoulosPropagator as JaxWM
from semiclassical_tpu.propagation import wm as jax_wm
from semiclassical_tpu.propagation.state import TrajState as JaxTrajState
from semiclassical_tpu_torch import convert, ops
from semiclassical_tpu_torch.ops import wm_diag
from semiclassical_tpu_torch.potentials import MorsePotential
from semiclassical_tpu_torch.propagation import WaltonManolopoulosPropagator
from semiclassical_tpu_torch.propagation import wm

D = 12
NTRAJ = 300
CELL = 1.0e4


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


def _model(d, seed=42):
    """The model of tests/test_ops.py::test_wm_diag_kernel_parity (unsorted
    omegas)."""
    rng = np.random.default_rng(seed)
    omega = rng.uniform(200.0, 3000.0, size=d) / units.hartree_to_wavenumbers
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1, 1, size=d)
    return omega, np.full(d, 0.02), nac, np.sqrt(2 * S / omega)


@pytest.fixture(scope="module")
def setup():
    """A JAX f64 WM propagator after 5 steps on the diagonal
    representation, and the port's potential, params, batch constants and
    state converted from it."""
    omega, chi, nac, q0 = _model(D)
    pot_j = jax_potentials.MorsePotential.create(omega, chi, nac)
    G = np.diag(omega)
    prop = JaxWM(G, G, CELL, CELL)
    prop.initial_conditions(q0, np.zeros(D), G, ntraj=NTRAJ, key=0,
                            potential=pot_j)
    prop.propagate(pot_j, 4.0, 5, check_energy=False)
    assert prop.params.scan_diag and prop.state.diag_monodromy
    return dict(
        G=G, q0=q0, pot_j=pot_j, prop_j=prop,
        pot=MorsePotential.create(omega, chi, nac, device="cpu"),
        params=convert.wm_params(_fields(prop.params), "cpu"),
        bc=convert.wm_batch_constants(_fields(prop._bc), "cpu"),
        state=convert.traj_state(_fields(prop.state), "cpu"))


def _planes(s):
    """K5's ten input planes and pack from the JAX state (as
    `_wm_scan_derived_diag` forms them)."""
    prop = s["prop_j"]
    hk, dg, st, bc = prop.params.hk, prop.params.diag, prop.state, prop._bc
    dQ = hk.q0[None, :] - st.q
    dp = st.p - hk.p0[None, :]
    dq = hk.q0[None, :] - bc.base.qi
    n1Q, _ = jax_wm._nac_terms(s["pot_j"], st.q)
    v0c = dg.ig0i[None, :] * (hk.p0[None, :] - bc.base.pi)
    planes = [st.Mqq, st.Mqp, st.Mpq, st.Mpp, dQ, dp, dq, bc.n1q, n1Q, v0c]
    pack = wm_kernel.build_const_pack(dg, hk.p0, prop.params.m_scale, D)
    return [np.asarray(x) for x in planes], np.array(pack)


def _row_errors(got, ref):
    """Largest error of each row (last axis) relative to its own largest
    entry (absolute for a row of zeros)."""
    scale = np.abs(ref).max(axis=-1)
    return np.abs(got - ref).max(axis=-1) / np.where(scale > 0, scale, 1.0)


def test_plain_f32_matches_pallas_kernel(setup):
    """K5's plain version against the Pallas kernel in interpret mode, both
    in float32, on a batch the kernel pads (n = 300, tile 512). The
    wavepacket momentum p0 is zero in the model; a nonzero p0 row goes
    into both packs so that the p0 sums are held too."""
    planes, pack = _planes(setup)
    planes32 = [p.astype(np.float32) for p in planes]
    port_pack = setup["params"].diag_pack.float()
    np.testing.assert_allclose(port_pack.numpy(), pack, rtol=1e-6)
    p0 = np.random.default_rng(3).standard_normal(D).astype(np.float32)
    pack[wm_diag.CONSTS.index("p0")] = p0
    port_pack[wm_diag.CONSTS.index("p0")] = torch.from_numpy(p0)
    scal_j, det_j = wm_kernel.pallas_wm_diag_derived(
        *map(jnp.asarray, planes32), jnp.asarray(pack), _force=True)
    scal_j = np.asarray(scal_j)[:wm_kernel.N_SCAL_LANES]      # (30, n)
    det_j = np.asarray(det_j)                                 # (4, d, n)
    scal, det = wm_diag.wm_diag_derived(
        *(torch.from_numpy(p) for p in planes32), port_pack)
    assert scal.dtype == det.dtype == torch.float32
    assert scal.shape == (NTRAJ, wm_diag.N_SCAL)
    assert det.shape == (4, NTRAJ, D)
    assert wm_diag.GRAM_PAIRS == wm_kernel.GRAM_PAIRS
    assert wm_diag.scal_col("p0_n") == wm_kernel.scal_row("p0_n")
    assert _row_errors(scal.numpy().T, scal_j).max() <= 1e-5
    assert _row_errors(det.numpy().transpose(0, 2, 1), det_j).max() <= 1e-5


def test_diag_packs_match_jax(setup):
    """WMDiagConsts and the whole WM pack built by the port equal the JAX
    package's, converted (1e-12)."""
    prop = WaltonManolopoulosPropagator(setup["G"], setup["G"], CELL, CELL,
                                        device="cpu")
    prop.initial_conditions(setup["q0"], np.zeros(D), setup["G"],
                            setup["pot"], ntraj=4)
    mine, ref = prop.params, setup["params"]
    assert mine.scan_diag and ref.scan_diag
    for f in dataclasses.fields(wm.WMDiagConsts):
        np.testing.assert_allclose(getattr(mine.diag, f.name).numpy(),
                                   getattr(ref.diag, f.name).numpy(),
                                   rtol=1e-12, atol=0, err_msg=f.name)
    np.testing.assert_allclose(mine.diag_pack.numpy(), ref.diag_pack.numpy(),
                               rtol=1e-12, atol=0)
    for name in ("diag_k", "R_diag", "shift_diag"):
        np.testing.assert_allclose(getattr(mine.hk, name).numpy(),
                                   getattr(ref.hk, name).numpy(),
                                   rtol=1e-12, atol=0, err_msg=name)
    np.testing.assert_allclose(mine.hk.csot0.diag_w.numpy(),
                               ref.hk.csot0.diag_w.numpy(), rtol=1e-12)


def test_diag_core_matches_jax(setup):
    ref = jax_wm._wm_diag_core(setup["prop_j"].params, setup["prop_j"].state)
    got = wm._wm_diag_core(setup["params"], setup["state"])
    for name, g, r in zip(("detA", "detM", "y1", "y2", "iM"), got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        assert np.abs(g.numpy() - r).max() <= 1e-12 * np.abs(r).max(), name


SCAN_FIELDS = ("detA", "detM", "gamma", "rqq", "rQQ", "rqQ", "Pq_dq",
               "PQ_dQ", "kfac")


def test_scan_derived_matches_jax_unfused(setup, monkeypatch):
    """The port's separable wm_scan_derived (K5's plain version on the CPU)
    against the JAX package's unfused chain (kernel off), every field at
    1e-12 of its largest entry."""
    monkeypatch.setattr(jax_wm, "_KERNEL_MODE", "0")
    prop = setup["prop_j"]
    ref = jax_wm.wm_scan_derived(prop.params, prop._bc, prop.state,
                                 setup["pot_j"])
    got = wm.wm_scan_derived(setup["params"], setup["bc"], setup["state"],
                             setup["pot"])
    for name in SCAN_FIELDS:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= 1e-12 * np.abs(r).max(), name


def test_diag_path_matches_dense_path(setup):
    """The separable path against the port's own dense path (the generic
    projected-2r chain with K2 at its leaves) on the same diagonal state."""
    params, bc, state = setup["params"], setup["bc"], setup["state"]
    diag = wm.wm_scan_derived(params, bc, state, setup["pot"])
    dense = wm.wm_scan_derived(dataclasses.replace(params, scan_diag=False),
                               bc, state, setup["pot"])
    for name in SCAN_FIELDS:
        g, r = getattr(diag, name).numpy(), getattr(dense, name).numpy()
        np.testing.assert_allclose(g, r, rtol=1e-10,
                                   atol=1e-12 * np.abs(r).max(),
                                   err_msg=name)


def test_kernel_args_are_checked():
    """What the kernel does not take raises before any launch."""
    n, d = 8, 5
    planes = [torch.zeros(n, d, dtype=torch.float64) for _ in range(10)]
    pack = torch.zeros(len(wm_diag.CONSTS), d, dtype=torch.float64)
    wm_diag.check_args(planes, pack)
    bad = [
        (planes, pack.float(), "one type"),
        (planes, torch.zeros(16, d, dtype=torch.float64), "constant pack"),
        (planes[:9] + [torch.zeros(n, d + 1, dtype=torch.float64)], pack,
         "planes"),
        (planes[:9] + [torch.zeros(d, n, dtype=torch.float64).T], pack,
         "contiguous"),
        ([torch.zeros(n, 300) for _ in range(10)],
         torch.zeros(len(wm_diag.CONSTS), 300), "d <= 256"),
        ([p.to(torch.int64) for p in planes], pack.to(torch.int64),
         "float64 or float32"),
    ]
    for args in bad:
        with pytest.raises(ValueError, match=args[2]):
            wm_diag.check_args(args[0], args[1])
    before = ops.launch_counts()
    wm_diag.wm_diag_derived(*planes, pack)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        wm_diag.wm_diag_derived(*planes, pack.to("meta"))


def test_wm_propagate_matches_jax(ref_data, monkeypatch):
    """WM (alpha = beta = 500) on the 5-mode AS model over 20 steps at 64
    trajectories with the same normals: C(t) and k~ic(t) at 1e-8, the
    three sign trackers equal."""
    model = ref_data / "AnharmonicAS" / "5modes" / "AS_model_chi0.02.dat"
    if not model.exists():
        pytest.skip(f"{model} not available")
    data = np.loadtxt(model)
    omega = data[:, 0] / units.hartree_to_wavenumbers
    S, nac, chi = data[:, 1], data[:, 2], data[:, 3]
    q0 = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    G, d, n = np.diag(omega), 5, 64
    en0, dt = float(np.sum(0.5 * omega)), 8.0
    normals = np.random.default_rng(29).standard_normal((n, 2 * d))
    pot_j = jax_potentials.MorsePotential.create(omega, chi, nac)
    pot = MorsePotential.create(omega, chi, nac, device="cpu")

    sp = jax_sampling.SamplingParams.create(q0, 0 * q0, G, G)
    monkeypatch.setattr(jax_sampling, "_standard_normals",
                        lambda params, key, ntraj, method:
                        jnp.asarray(normals))
    qi, pi, log_prob = jax_sampling.sample_initial_conditions(sp, None, n)
    prop_j = JaxWM(G, G, 500.0, 500.0)
    prop_j.initial_conditions(q0, 0 * q0, G, ntraj=n, key=0, potential=pot_j)
    prop_j.state = JaxTrajState.initial(qi, pi, diag_monodromy=True)
    prop_j._bc = jax_wm.wm_batch_constants(prop_j.params, qi, pi, log_prob,
                                           potential=pot_j)
    prop_j._bc_has_nacq = True
    prop_j.trackers = prop_j._make_trackers(prop_j.state)
    cj, kj = prop_j.propagate(pot_j, dt, 20, energy0_es=en0)

    prop = WaltonManolopoulosPropagator(G, G, 500.0, 500.0, device="cpu")
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=n,
                            normals=torch.from_numpy(normals))
    c, k = prop.propagate(pot, dt, 20, energy0_es=en0)
    assert prop.params.scan_diag and prop.state.diag_monodromy
    np.testing.assert_allclose(c, cj, rtol=0, atol=1e-8 * np.abs(cj).max())
    np.testing.assert_allclose(k, kj, rtol=0, atol=1e-8 * np.abs(kj).max())
    for name in ("prefactorC", "detA", "detM"):
        np.testing.assert_array_equal(
            getattr(prop.tracker, name).signs.numpy(),
            np.asarray(prop_j.trackers[name].signs), err_msg=name)
