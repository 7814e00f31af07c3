# coding: utf-8
"""Broadening functions.

Broadening functions are the Fourier transforms of the corresponding lineshape
functions; the factories below return a callable g(t) evaluated on a time
grid. Behavioural parity with reference broadening.py:25-146, with one fix:
the reference's `voigtian` composes the *factories* instead of the evaluated
lineshapes (reference broadening.py:144 — would raise TypeError if ever
called); here the Voigt profile correctly multiplies the evaluated Gaussian
and Lorentzian time-domain factors.
"""

__all__ = ["gaussian", "lorentzian", "voigtian"]

import numpy as np


def gaussian(sigma):
    """Time-domain lineshape of a Gaussian energy distribution.

    G(w) = 1/(sqrt(2 pi) sigma) exp(-1/2 (w/sigma)^2)
    g(t) = 1/(2 pi) exp(-1/2 sigma^2 t^2)

    Parameters
    ----------
    sigma : float
        standard deviation of the Gaussian in the energy domain (Hartree)
    """

    def lineshape(t):
        t = np.asarray(t)
        return np.exp(-0.5 * sigma**2 * t**2) / (2.0 * np.pi)

    return lineshape


def lorentzian(gamma):
    """Time-domain lineshape of a Lorentzian energy distribution.

    L(w) = gamma / (pi (gamma^2 + w^2))
    l(t) = 1/(2 pi) exp(-gamma |t|)

    Parameters
    ----------
    gamma : float
        width parameter of the Lorentzian in the energy domain (Hartree)
    """

    def lineshape(t):
        t = np.asarray(t)
        return np.exp(-gamma * np.abs(t)) / (2.0 * np.pi)

    return lineshape


def voigtian(sigma, gamma):
    """Time-domain lineshape of a Voigt profile (Gaussian (*) Lorentzian).

    By the convolution theorem the time-domain factor is the product of the
    Gaussian and Lorentzian time-domain factors. The extra 2 pi restores the
    1/(2 pi) normalisation convention shared by `gaussian` and `lorentzian`:
    v(t) = 2 pi g(t) l(t) = 1/(2 pi) exp(-1/2 sigma^2 t^2 - gamma |t|).

    Parameters
    ----------
    sigma : float
        standard deviation of the Gaussian component (Hartree)
    gamma : float
        width parameter of the Lorentzian component (Hartree)
    """
    g = gaussian(sigma)
    l = lorentzian(gamma)

    def lineshape(t):
        t = np.asarray(t)
        return 2.0 * np.pi * g(t) * l(t)

    return lineshape
