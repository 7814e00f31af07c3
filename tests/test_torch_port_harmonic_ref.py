# coding: utf-8
"""The port's HK on methylium's molecular harmonic PES against the
benchmark's plain reference (`benchmark/reference/hk_harmonic.py`: the
quadratic PES of the ground checkpoint, RK4 with the dense monodromy's
stages written out, the rank-6 prefactor's determinant by the library's
LU; no module of the port and no JAX), on the CPU.

16 trajectories of seeded normals, 40 steps in segments of 20, at the
methylium cell's time step and at one 40 times as long. C(t) and
k~ic(t) agree to 1e-12 of their largest modulus: both sides run the same
float64 formulas in a different order (the port applies RK4's step map
to the monodromy as one matrix, the reference its four stages; the port
packs the prefactor's factors, the reference multiplies the blocks), so
they part by rounding alone, ~7e-15 over 40 steps, and nothing of the
mathematics differs. The reference computed at float32 in the port's
place misses that tolerance (by ~1e-6), and so does the port with the
NAC factor's sign at the current point flipped.
"""

import functools
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from semiclassical_tpu_torch import cli, units
from semiclassical_tpu_torch.propagation import HermanKlukPropagator, hk

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = "benchmark/data"
POTENTIAL = {"type": "harmonic", "ground": f"{DATA}/methylium_s0.fchk",
             "excited": f"{DATA}/methylium_s1.fchk",
             "coupling": f"{DATA}/methylium_s1.fchk"}
NTRAJ, NT, CHUNK = 16, 40, 20
# the methylium cell's 0.005 fs, and a step 40 times as long
DT_CELL_FS = 0.005
DT_COARSE_FS = 40 * DT_CELL_FS
TOL = 1e-12


@pytest.fixture(scope="module")
def hk_harmonic():
    """The benchmark's plain reference, from `benchmark/` on sys.path as
    the harness has it."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        return importlib.import_module("reference.hk_harmonic")
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _task(dt_fs):
    return {"potential": POTENTIAL, "propagator": "HK",
            "batch_size": NTRAJ, "num_steps": NT, "time_step_fs": dt_fs,
            "scan_chunk": CHUNK}


def _normals(rank):
    rng = np.random.default_rng(2026)
    return torch.from_numpy(rng.standard_normal((NTRAJ, 2 * rank)))


@functools.lru_cache(maxsize=None)
def _setup():
    """The CLI's methylium potential, wavepacket and zero-point energy."""
    pot = {k: str(ROOT / v) if k != "type" else v
           for k, v in POTENTIAL.items()}
    potential, q0, p0, G0, e0, _, _ = cli._build_potential(
        {"potential": pot}, torch.device("cpu"))
    return potential, q0, p0, G0, e0


def _port(dt_fs, rank):
    """The port's HK `propagate` in segments of CHUNK: (C(t), k~ic(t))."""
    potential, q0, p0, G0, e0 = _setup()
    prop = HermanKlukPropagator(G0, G0, device="cpu")
    prop.initial_conditions(q0, p0, G0, potential, ntraj=NTRAJ,
                            normals=_normals(rank))
    assert not prop.state.diag_monodromy and prop.params.rank == rank
    c, k = prop.propagate(potential, dt_fs / units.autime_to_fs, NT,
                          energy0_es=e0, chunk=CHUNK)
    return np.asarray(c), np.asarray(k)


def _gaps(hk_harmonic, dt_fs, dtype=torch.float64):
    task = _task(dt_fs)
    rank = hk_harmonic.rank(task, None)
    ref = hk_harmonic.repetition(task, None, _normals(rank), dtype)
    c, k = _port(dt_fs, rank)
    return [float(np.max(np.abs(got - ref[key]))
                  / np.max(np.abs(ref[key])))
            for got, key in ((c, "cauto"), (k, "kic"))]


@pytest.mark.parametrize("dt_fs, dtype, agrees", [
    (DT_CELL_FS, torch.float64, True),
    (DT_COARSE_FS, torch.float64, True),
    (DT_CELL_FS, torch.float32, False)], ids=["f64", "f64-coarse", "f32"])
def test_port_against_the_plain_reference(hk_harmonic, dt_fs, dtype,
                                          agrees):
    gaps = _gaps(hk_harmonic, dt_fs, dtype)
    if agrees:
        assert max(gaps) <= TOL, gaps
    else:
        assert min(gaps) > TOL, gaps


def test_the_reference_is_rank_six(hk_harmonic):
    assert hk_harmonic.rank(_task(DT_CELL_FS), None) == 6


@pytest.mark.parametrize("dt_fs", [DT_CELL_FS, DT_COARSE_FS],
                         ids=["cell", "coarse"])
def test_a_flipped_nac_sign_misses(hk_harmonic, monkeypatch, dt_fs):
    """The NAC factor at the current point taken with the initial point's
    sign: C(t) is untouched, k~ic(t) misses."""
    real = hk._nac_factor

    def flipped(params, potential, x, pvec, sign, xc=None):
        return real(params, potential, x, pvec, abs(sign), xc)

    monkeypatch.setattr(hk, "_nac_factor", flipped)
    gap_c, gap_k = _gaps(hk_harmonic, dt_fs)
    assert gap_c <= TOL and gap_k > TOL, (gap_c, gap_k)
