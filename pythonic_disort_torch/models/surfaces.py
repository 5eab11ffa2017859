"""Built-in surface BDRF models.

The port's own copy of ``pythonic_disort_tpu/models/surfaces.py``.  The
reference leaves BDRF construction to the user (tests build Hapke
inline, ``pydisotest/6_test.py:11-24``); the package ships the two
standard models plus the Fourier-mode machinery to plug any azimuthal
BDRF into the solver.
"""

from __future__ import annotations

import numpy as np

from ..utils.bdrf import fourier_modes_from_bdrf


def lambertian(albedo):
    """Lambertian surface: a single constant Fourier mode."""
    return [float(albedo)]


def hapke(B0=1.0, HH=0.06, W=0.6):
    """The Hapke (1981) BDRF ``f(mu, mu', dphi)``.

    Opposition-effect amplitude ``B0``, angular width ``HH``,
    single-scattering albedo ``W`` (parameter names follow DISORT's
    test problems).
    """

    def bdrf(mu, neg_mup, dphi):
        mu = np.asarray(mu)
        neg_mup = np.asarray(neg_mup)
        cos_alpha = (
            mu[:, None] * neg_mup[None, :]
            - np.sqrt(1 - mu**2)[:, None]
            * np.sqrt(1 - neg_mup**2)[None, :]
            * np.cos(dphi)
        ).clip(-1, 1)
        alpha = np.arccos(cos_alpha)
        P = 1 + cos_alpha / 2
        Bf = B0 * HH / (HH + np.tan(alpha / 2))
        gamma = np.sqrt(1 - W)
        H0 = ((1 + 2 * neg_mup) / (1 + 2 * neg_mup * gamma))[None, :]
        H = ((1 + 2 * mu) / (1 + 2 * mu * gamma))[:, None]
        return W / 4 / (mu[:, None] + neg_mup[None, :]) * ((1 + Bf) * P + H0 * H - 1)

    return bdrf


def hapke_fourier_modes(nmodes, B0=1.0, HH=0.06, W=0.6, nquad_phi=512):
    """Hapke BDRF expanded into solver-ready Fourier modes."""
    return fourier_modes_from_bdrf(hapke(B0, HH, W), nmodes, nquad_phi)
