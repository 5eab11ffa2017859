"""BDRF surface-reflection helpers (host numpy and scipy).

The port's own copy of ``pythonic_disort_tpu/utils/bdrf.py``: the
capabilities of reference ``subroutines.py:459-570``
(``generate_emissivity_from_BDRF``, ``cache_BDRF_Fourier_modes``) plus
a Fourier-mode generator for azimuth-dependent BDRFs (the pattern the
reference tests construct inline via ``scipy.integrate.quad_vec``,
e.g. ``pydisotest/6_test.py:194-200``).

The solver consumes BDRF Fourier modes *pre-evaluated* on the
quadrature grid (see ``DisortProblem.bdrf_modes``); these helpers
operate host-side on the callable representation.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.quadrature import double_gauss


def generate_emissivity_from_BDRF(N, zeroth_BDRF_Fourier_mode):
    """Directional surface emissivity by Kirchhoff's law.

    ``1 - 2 * integral(BDRF_0(mu, mu') mu' dmu')`` over the quadrature
    hemisphere; a scalar mode yields ``1 - mode``.
    """
    if np.isscalar(zeroth_BDRF_Fourier_mode):
        return 1 - zeroth_BDRF_Fourier_mode
    mu, w = double_gauss(2 * N)
    return 1 - 2 * zeroth_BDRF_Fourier_mode(mu, mu) * mu[None, :] @ w


def cache_BDRF_Fourier_modes(N, BDRF_Fourier_modes, mu0=0):
    """Pre-evaluate BDRF Fourier-mode callables on the quadrature grid.

    Returns a list of callables with the same signature that replay the
    cached values (optionally also cached at ``mu0``), for repeated
    solves with the same surface.
    """
    import warnings

    mu0_caching = 0 < mu0 <= 1
    if not mu0_caching:
        warnings.warn("No caching with respect to `mu0`.")

    mu, _ = double_gauss(2 * N)
    cached = []
    for mode in BDRF_Fourier_modes:
        if np.isscalar(mode):
            cached.append(lambda mu_, neg_mup, v=mode: v)
            continue
        grid = np.asarray(mode(mu, mu))
        at_mu0 = (
            np.asarray(mode(mu, np.array([mu0]))) if mu0_caching else None
        )

        def replay(mu_, neg_mup, grid=grid, at_mu0=at_mu0, mode=mode):
            if len(neg_mup) == 1:
                if at_mu0 is not None:
                    return at_mu0
                return np.asarray(mode(mu, neg_mup))
            return grid

        cached.append(replay)
    return cached


def fourier_modes_from_bdrf(bdrf, nmodes, nquad_phi=128):
    """Azimuthal Fourier cosine modes of a full BDRF ``f(mu, mu', dphi)``.

    Returns a list of callables ``mode_m(mu, neg_mup)`` with
    ``mode_m = integral f cos(m dphi) ddphi / ((1 + (m==0)) pi)``,
    computed by fixed-order trapezoid on the periodic interval (which is
    spectrally accurate for smooth periodic integrands).
    """
    dphi = np.linspace(0.0, 2.0 * math.pi, nquad_phi, endpoint=False)
    wphi = 2.0 * math.pi / nquad_phi

    def make(m):
        def mode(mu, neg_mup, m=m):
            vals = np.stack([bdrf(mu, neg_mup, d) for d in dphi], axis=-1)
            integ = (vals * np.cos(m * dphi)).sum(axis=-1) * wphi
            return integ / ((1 + (m == 0)) * math.pi)

        return mode

    return [make(m) for m in range(nmodes)]
