# coding: utf-8
"""The origin of chip_smoke.py's taylor-vs-stage gates: the largest gap
max_t |C_taylor(t) - C_stage(t)| that the JAX package shows at float64 on
the CPU between the AS model's `hessian_eval` "taylor" with `taylor_every`
8 and the 4-stage Hessian, on the same draws, over the example's full 2000
steps of 0.005 fs in scan segments of 500 (the CLI's default for the AS
model, where the window restarts) at 256 trajectories: the 60-mode model of
examples/as_model/make_model.py with HK and with WM (cell width 1e4).
chip_smoke.py gates the port's gap on the card at 10x these values
(`TAYLOR_STAGE_GAP_JAX`); this file recomputes them and holds the constants
to them.
"""

import pathlib
import sys

import numpy as np
import pytest

from semiclassical_tpu import units
from semiclassical_tpu.propagation import (HermanKlukPropagator,
                                           WaltonManolopoulosPropagator)
from semiclassical_tpu.pytree import replace
from test_torch_port_exact_gap import _as_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the script imports only the standard library)

NTRAJ = 256
NSTEPS = 2000


@pytest.mark.parametrize("label", sorted(chip_smoke.TAYLOR_STAGE_GAP_JAX))
def test_jax_taylor_stage_gap_is_the_gate_origin(label):
    name = label.split()[0]
    pot, q0, G, zpe = _as_model()
    cls, args = ((WaltonManolopoulosPropagator, (1e4, 1e4)) if name == "WM"
                 else (HermanKlukPropagator, ()))
    dt = 0.005 / units.autime_to_fs
    curves = {}
    for mode, p in (("stage", pot),
                    ("taylor", replace(pot, hessian_eval="taylor",
                                       taylor_every=8))):
        prop = cls(G, G, *args)
        prop.initial_conditions(q0, 0 * q0, G, ntraj=NTRAJ, key=3,
                                potential=p)
        curves[mode] = prop.propagate(p, dt, NSTEPS, energy0_es=zpe,
                                      chunk=500)[0]
    gap = np.abs(curves["taylor"] - curves["stage"]).max()
    assert gap > 0.0
    assert chip_smoke.TAYLOR_STAGE_GAP_JAX[label] == pytest.approx(gap,
                                                                    rel=0.02)
