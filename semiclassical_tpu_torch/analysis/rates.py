# coding: utf-8
"""Rate constants and spectra by Fourier transform of correlation functions.

The same host-side numpy pipeline as `semiclassical_tpu.analysis.rates`:
the rate transform of k~ic(t), the spectrum transform of C(t), and the
propagation of the per-step Monte-Carlo standard errors through both. It
runs once per job on a ~10^3-point array, so there is nothing for the GPU
to do here.
"""

__all__ = ["rate_from_correlation", "spectrum_from_correlation",
           "fourier_stderr"]

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


def fourier_stderr(times, stderr, lineshape):
    """Monte-Carlo standard error of the windowed Fourier integral of
    `_fourier_transform`, from the per-step standard errors of the
    correlation function (the `error_bars` task keyword).

    The transform is linear in c(t). With the per-step errors independent
    across steps and isotropic in the complex plane (Var Re = Var Im =
    sigma_t^2 / 2), and the Hermitian extension c(-t) = c(t)^* reusing each
    t > 0 sample (fully correlated, not a second draw), the variance

        Var[Re I(E)] = dt^2 (w_0^2 sigma_0^2 / 2 + 2 sum_{t>0} w_t^2 sigma_t^2)

    does not depend on E: one scalar is the band of every energy. The
    independence across steps is an approximation (all steps share one
    ensemble); the band is a convergence scale, like the per-step stderr.

    Parameters
    ----------
    times : real ndarray (nt,), equidistant, starting at 0
    stderr : real ndarray (nt,), per-step total complex standard error
    lineshape : callable, the lineshape passed to the transform (even in t)

    Returns
    -------
    sigma : float, standard error of Re I(E) in the transform's units
    """
    times = np.asarray(times)
    stderr = np.asarray(stderr)
    if times.shape != stderr.shape:
        raise ValueError(
            "arrays `times` and `stderr` should have the same length")
    dt = times[1] - times[0]
    # tolerate float fuzz on the origin (a concatenated grid may carry
    # accumulated error)
    if not abs(times[0]) < 1e-9 * max(abs(dt), 1e-300):
        raise ValueError(
            f"time grid must start at t=0 (got times[0]={times[0]!r}); "
            "fourier_stderr's symmetric-extension bookkeeping assumes the "
            "grid of _fourier_transform")
    t_max = times.max()
    window = lineshape(times) * np.cos(0.5 * np.pi * times / t_max) ** 2
    w2s2 = (window * stderr) ** 2
    var = dt * dt * (0.5 * w2s2[0] + 2.0 * w2s2[1:].sum())
    return float(np.sqrt(var))


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


def spectrum_from_correlation(times, correlation, lineshape):
    """Spectral density S(E) as the Fourier transform of the wavepacket
    autocorrelation C(t) = <phi(0)|phi(t)>:

        S(E) = \\int dt  e^{i E t / hbar} f~(t) C(t)

    with the time-domain lineshape f~(t) (which carries the 1/(2 pi) of the
    Fourier convention, `broadening`). With the stored phase convention
    C(t) = e^{i E0 t} <phi|e^{-iHt}|phi> the peaks sit at E_n - E0 with
    Franck-Condon areas |<phi|n>|^2, and S integrates to f~(0)-normalised
    C(0) ~ 1 for a normalised wavepacket.

    Returns (energies (2 nt - 1,) in Hartree, spectrum (2 nt - 1,) complex
    in 1/Hartree, real up to FFT noise).
    """
    return _fourier_transform(times, correlation, lineshape)
