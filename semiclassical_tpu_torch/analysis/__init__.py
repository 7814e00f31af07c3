# coding: utf-8
"""Spectral analysis: lineshape functions and the FFT rate pipeline."""

from semiclassical_tpu_torch.analysis.broadening import (gaussian, lorentzian,
                                                         voigtian)
from semiclassical_tpu_torch.analysis.rates import rate_from_correlation

__all__ = ["gaussian", "lorentzian", "voigtian", "rate_from_correlation"]
