# coding: utf-8
"""Propagation: trajectory state, equations of motion + RK4, HK."""

from semiclassical_tpu_torch.propagation.hk import HermanKlukPropagator
from semiclassical_tpu_torch.propagation.state import SignTracker, TrajState

__all__ = ["HermanKlukPropagator", "SignTracker", "TrajState"]
