# coding: utf-8
"""Phase timing and per-run metrics.

* `PhaseTimer` — wall-clock accounting per phase (sample / scan / reduce)
  with a throughput summary in trajectory-steps per second. PyTorch returns
  before the card has finished, so a phase that closes on a CUDA device
  first waits for it (`torch.cuda.synchronize`): the time is the card's
  work, not its enqueueing.
* `RunMetrics` — structured per-batch diagnostics (energy drift, |C(t)|
  extrema, NaN flags) gathered once per batch on the host, never per step.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["PhaseTimer", "RunMetrics"]


class PhaseTimer:
    """Accumulates wall-clock per phase; computes the throughput metric."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def throughput(self, traj_steps, phase="scan"):
        """trajectory-steps per second of wall time in the given phase."""
        wall = self.phases.get(phase, 0.0)
        if wall <= 0:
            return float("nan")
        return traj_steps / wall

    def log(self, traj_steps=None):
        for name, wall in sorted(self.phases.items()):
            logger.info(f"  phase {name:10s}: {wall:9.3f} s")
        if traj_steps:
            logger.info(f"  throughput: {self.throughput(traj_steps):,.0f} "
                        f"traj-steps/s on {self.device}")


@dataclass
class RunMetrics:
    """Structured per-batch physics diagnostics."""

    energy_drift_max: float = float("nan")
    c0_deviation: float = float("nan")
    abs_c_max: float = float("nan")
    abs_kic_max: float = float("nan")
    nan_detected: bool = False

    @staticmethod
    def from_run(energies, cauto, kic):
        energies = np.asarray(energies)
        cauto = np.asarray(cauto)
        kic = np.asarray(kic)
        drift = np.abs(np.diff(energies)).max() if energies.size > 1 else 0.0
        return RunMetrics(
            energy_drift_max=float(drift),
            c0_deviation=float(abs(cauto[0] - 1.0)),
            abs_c_max=float(np.abs(cauto).max()),
            abs_kic_max=float(np.abs(kic).max()),
            nan_detected=bool(np.isnan(cauto).any() or np.isnan(kic).any()
                              or np.isnan(energies).any()),
        )

    def to_json(self):
        return json.dumps(self.__dict__.copy())

    def log(self):
        logger.info(f"  metrics: {self.to_json()}")
