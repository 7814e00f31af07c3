# coding: utf-8
"""The port's separable WM path against the benchmark's plain reference
(`benchmark/reference/wm_separable.py`: Walton-Manolopoulos per mode,
closed 2x2 inverses, no module of the port and no JAX), on the CPU.

WM with the benchmark's cell width (1e4) on the 5-mode AS model, 64
trajectories of seeded normals, 30 steps, at the AS cells' time step and
at a coarse one: C(t) and k~ic(t) agree to 1e-12 of their largest value
(the two sides round differently, ~1e-15, and nothing else differs). The
reference computed at float32 in the port's place misses that tolerance
(by ~1e-7), so the comparison can tell a lower precision.
"""

import functools
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch import units
from semiclassical_tpu_torch.potentials import MorsePotential
from semiclassical_tpu_torch.propagation import WaltonManolopoulosPropagator

ROOT = pathlib.Path(__file__).resolve().parents[1]
AS5 = ROOT / "tests/data/refdata/AnharmonicAS/5modes/AS_model_chi0.02.dat"
CELL = 1.0e4
NTRAJ, NT = 64, 30
# the AS cells' 0.005 fs, and a step 40 times as long
DT_CELL = 0.005 / units.autime_to_fs
DT_COARSE = 40 * DT_CELL
TOL = 1e-12


@pytest.fixture(scope="module")
def wm_separable():
    """The benchmark's plain reference, from `benchmark/` on sys.path as
    the harness has it."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        return importlib.import_module("reference.wm_separable")
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normals():
    rng = np.random.default_rng(2026)
    return torch.from_numpy(rng.standard_normal((NTRAJ, 10)))


@functools.lru_cache(maxsize=None)
def _port(dt):
    """The port's WM `propagate` on the 5-mode model: (C(t), k~ic(t))."""
    data = np.loadtxt(AS5)
    omega = data[:, 0] / units.hartree_to_wavenumbers
    S, nac, chi = data[:, 1], data[:, 2], data[:, 3]
    q0 = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    G = np.diag(omega)
    pot = MorsePotential.create(omega, chi, nac, device="cpu")
    prop = WaltonManolopoulosPropagator(G, G, CELL, CELL, device="cpu")
    prop.initial_conditions(q0, 0 * q0, G, pot, ntraj=NTRAJ,
                            normals=_normals())
    assert prop.params.scan_diag and prop.state.diag_monodromy
    c, k = prop.propagate(pot, dt, NT, energy0_es=float(np.sum(0.5 * omega)))
    return np.asarray(c), np.asarray(k)


def _gap(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("dt, dtype, agrees", [
    (DT_CELL, torch.float64, True),
    (DT_COARSE, torch.float64, True),
    (DT_CELL, torch.float32, False)], ids=["f64", "f64-coarse", "f32"])
def test_port_against_the_plain_reference(wm_separable, dt, dtype, agrees):
    ref = wm_separable.propagate(np.loadtxt(AS5), _normals(), dt, NT, CELL,
                                 CELL, dtype)
    c, k = _port(dt)
    gaps = [_gap(c, ref["cauto"]), _gap(k, ref["kic"])]
    if agrees:
        assert max(gaps) <= TOL, gaps
    else:
        assert min(gaps) > TOL, gaps
