"""Planck band integrals in float64, the reference's own.

The blackbody radiance per unit wavenumber, 2 h c^2 nu^3 / (exp(h c nu /
k T) - 1) with nu in cm^-1 (W m^-2 sr^-1 per cm^-1), integrated over a
band by composite Gauss-Legendre quadrature on panels of equal width;
at 64 panels of 16 nodes the sum converges to float64's rounding over
the bands and temperatures of the cells.
"""

from __future__ import annotations

import numpy as np
import scipy.constants as const

C2 = 100.0 * const.h * const.c / const.k          # cm K
PREF = 2e8 * const.h * const.c**2                  # W m^-2 sr^-1 (cm^-1)^-4


def radiance(T, nu):
    """Planck radiance at temperatures ``T`` (K) and wavenumbers ``nu`` (cm^-1)."""
    x = C2 * nu / T
    return PREF * nu**3 / np.expm1(x)


def band_emission(T, lo, hi, panels=64, order=16):
    """Integral of `radiance` over [lo, hi] cm^-1 for every temperature in ``T``."""
    x, w = np.polynomial.legendre.leggauss(order)
    edges = np.linspace(lo, hi, panels + 1)
    a, b = edges[:-1, None], edges[1:, None]
    nodes = (0.5 * (b - a) * x + 0.5 * (a + b)).ravel()
    weights = (0.5 * (b - a) * w).ravel()
    T = np.asarray(T, np.float64)
    return radiance(T[..., None], nodes) @ weights
