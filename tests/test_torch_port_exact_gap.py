# coding: utf-8
"""The origin of chip_smoke.py's exact-vs-RK4 gates: the largest gap
max_t |C_exact(t) - C_rk4(t)| that the JAX package shows at float64 on the
CPU between its two integrators, on the same draws, over the examples'
full 2000 steps of 0.005 fs at 256 trajectories — methylium with HK and
the 60-mode AS model (examples/as_model/make_model.py) with HK and WM.
chip_smoke.py gates the port's gap on the card at 10x these values
(`EXACT_RK4_GAP_JAX`); this file recomputes them and holds the constants
to them.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from semiclassical_tpu import potentials, units
from semiclassical_tpu.io.fchk import FormattedCheckpointFile
from semiclassical_tpu.propagation import (HermanKlukPropagator,
                                           WaltonManolopoulosPropagator)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the script imports only the standard library)

NTRAJ = 256
NSTEPS = 2000


def _methylium(ref_data):
    base = ref_data / "examples" / "methylium_AH"
    if not (base / "opt_freq_s0.fchk").exists():
        pytest.skip("methylium fixtures not available")

    def read(name):
        with open(base / name) as f:
            return FormattedCheckpointFile(f)

    x0, G0, zpe = read("opt_freq_s1.fchk").vibrational_groundstate()
    pot = potentials.minimize(potentials.MolecularHarmonicPotential.from_fchk(
        read("opt_freq_s0.fchk"), read("opt_freq_s1.fchk")), jnp.asarray(x0))
    return pot, np.asarray(x0), G0, zpe


def _as_model():
    script = ROOT / "examples" / "as_model" / "make_model.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    data = np.loadtxt(out.splitlines())
    omega = data[:, 0] / units.hartree_to_wavenumbers
    S, nac, chi = data[:, 1], data[:, 2], data[:, 3]
    dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    return (potentials.MorsePotential.create(omega, chi, nac), dQ,
            np.diag(omega), float(np.sum(0.5 * omega)))


@pytest.mark.parametrize("label", sorted(chip_smoke.EXACT_RK4_GAP_JAX))
def test_jax_exact_rk4_gap_is_the_gate_origin(ref_data, label):
    name, model = label.split()
    pot, q0, G, zpe = _methylium(ref_data) if model == "methylium" \
        else _as_model()
    cls, args = ((WaltonManolopoulosPropagator, (1e4, 1e4)) if name == "WM"
                 else (HermanKlukPropagator, ()))
    dt = 0.005 / units.autime_to_fs
    curves = {}
    for integrator in ("rk4", "exact"):
        prop = cls(G, G, *args, integrator=integrator)
        prop.initial_conditions(q0, 0 * q0, G, ntraj=NTRAJ, key=3,
                                potential=pot)
        curves[integrator] = prop.propagate(pot, dt, NSTEPS, energy0_es=zpe,
                                            chunk=500)[0]
    gap = np.abs(curves["exact"] - curves["rk4"]).max()
    assert 0.0 < gap < 1e-9
    assert chip_smoke.EXACT_RK4_GAP_JAX[label] == pytest.approx(gap,
                                                                 rel=0.02)
