# coding: utf-8
"""Propagation: trajectory state, equations of motion + RK4, HK and WM."""

from semiclassical_tpu_torch.propagation.hk import HermanKlukPropagator
from semiclassical_tpu_torch.propagation.state import SignTracker, TrajState
from semiclassical_tpu_torch.propagation.wm import \
    WaltonManolopoulosPropagator

__all__ = ["HermanKlukPropagator", "WaltonManolopoulosPropagator",
           "SignTracker", "TrajState"]
