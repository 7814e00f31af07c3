# coding: utf-8
"""Rate constants by Fourier transform of correlation functions.

The same host-side numpy pipeline as `semiclassical_tpu.analysis.rates`
(the rate transform only; the spectrum transform and the error-bar
propagation are not ported yet). It runs once per job on a ~10^3-point
array, so there is nothing for the GPU to do here.
"""

__all__ = ["rate_from_correlation"]

import numpy as np
from numpy import fft

from semiclassical_tpu_torch import units


def _fourier_transform(times, correlation, lineshape):
    """Windowed Fourier integral I(E) = \\int dt e^{i E t} f~(t) c(t) of a
    correlation function sampled on [0, t_max], extended Hermitianly to
    negative times.

    Returns (energies, integral) with energies fftshifted to ascending
    order, in Hartree; the integral is in atomic units of 1/energy times
    the correlation's units.
    """
    times = np.asarray(times)
    correlation = np.asarray(correlation)
    if times.min() != 0.0:
        raise ValueError("time grid `times` should start at 0.0")
    if times.shape != correlation.shape:
        raise ValueError(
            "arrays `times` and `correlation` should have the same length")
    nt = times.shape[0]
    t_max = times.max()
    n_sym = 2 * nt - 1

    # Hermitian extension onto [-t_max, t_max]: only t >= 0 was propagated;
    # c(-t) = c(t)^* because the transform I(E) is real.
    t_sym = np.linspace(-t_max, t_max, n_sym)
    corr_sym = np.concatenate([correlation[:0:-1].conj(), correlation])

    # lineshape times a cos^2 (Gibbs) taper that takes the integrand
    # smoothly to zero at +-t_max
    window = lineshape(t_sym) * np.cos(0.5 * np.pi * t_sym / t_max) ** 2

    # ifft computes the mean over the grid (1/N included); scaling by the
    # periodic window length n_sym * dt turns that mean into the Riemann
    # sum dt * sum_k x_k. The DFT bin energies use the actual sample
    # spacing dt = 2 t_max / (n_sym - 1), as the JAX package does.
    dt = times[1] - times[0]
    integral = n_sym * dt * fft.ifft(fft.ifftshift(window * corr_sym))

    energies = 2.0 * np.pi * fft.fftfreq(n_sym, d=dt)
    return fft.fftshift(energies), fft.fftshift(integral)


def rate_from_correlation(times, correlation, lineshape):
    """Rate constant k(E) as the Fourier transform of the correlation k~(t).

    The environment is included by damping k~(t) with the time-domain
    lineshape f~(t):

        k(E) = 1/(2 pi hbar) \\int dt  e^{i E t / hbar} f~(t) k~(t)

    Parameters
    ----------
    times : real ndarray (nt,)
        equidistant time grid covering [0, t_max]
    correlation : complex ndarray (nt,)
        correlation function k~(t) on the time grid
    lineshape : callable
        time-domain lineshape f~(t), called as ``lineshape(times)``

    Returns
    -------
    energies : real ndarray (2 nt - 1,)
        energy gap E (Hartree)
    rate : complex ndarray (2 nt - 1,)
        rate constant k(E) (s^-1)
    """
    energies, rate = _fourier_transform(times, correlation, lineshape)
    rate = rate * 1.0e15 / units.autime_to_fs   # a.u.(time)^-1 -> s^-1
    return energies, rate
