# coding: utf-8
"""Spectral analysis: lineshape functions, the FFT rate and spectrum
pipelines and their Monte-Carlo error bands."""

from semiclassical_tpu_torch.analysis.broadening import (gaussian, lorentzian,
                                                         voigtian)
from semiclassical_tpu_torch.analysis.rates import (fourier_stderr,
                                                    rate_from_correlation,
                                                    spectrum_from_correlation)

__all__ = ["gaussian", "lorentzian", "voigtian", "rate_from_correlation",
           "spectrum_from_correlation", "fourier_stderr"]
