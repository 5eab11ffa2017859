"""Thermal-source helpers: Planck emission and source-polynomial setup.

The port's own copy of ``pythonic_disort_tpu/utils/thermal.py``: host
functions mirroring reference ``subroutines.py:322-454`` (``Planck``,
``blackbody_contrib_to_BCs``, ``linear_spline_coefficients``,
``generate_s_poly_coeffs``).  Units follow Stamnes' DISORT: wavenumbers
in m^-1, emitted power in W/m^2.

Band integrals here use adaptive quadrature on the host (inputs are
static per problem).  The fixed-order device route for spectral sweeps,
differentiable through ``torch.autograd``, is ``ops/planck.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.constants as const
import scipy.integrate


def planck(T, WVNM):
    """Blackbody surface emission in W/m^2 at temperature(s) T [K] and
    wavenumber WVNM [m^-1].  Overflow-safe for small T."""
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    out = np.zeros(T.shape)
    nz = T != 0
    if np.any(nz):
        x = 100.0 * const.h * const.c * WVNM / (const.k * T[nz])
        e = np.exp(-x)
        out[nz] = (2e8 * const.h * const.c**2 * WVNM**3 * e) / (1.0 - e)
    return np.squeeze(out)[()]


# Reference-compatible capitalized alias.
Planck = planck


def blackbody_contrib_to_BCs(T, WVNMLO, WVNMHI, **kwargs):
    """Band-integrated blackbody emission of a boundary, W/m^2.

    Integrates ``planck(T, .)`` over ``[WVNMLO, WVNMHI]``; use for the
    Dirichlet boundary sources ``b_pos``/``b_neg`` (emissivity applied
    by the caller, e.g. via ``generate_emissivity_from_BDRF``).
    """
    val, _ = scipy.integrate.quad_vec(
        lambda wv: np.atleast_1d(planck(T, wv)), WVNMLO, WVNMHI, **kwargs
    )
    return np.squeeze(val)[()]


def linear_spline_coefficients(x, y, check_inputs=True):
    """Per-segment ``[intercept, slope]`` coefficients of a linear spline.

    Rows are segments; columns are ascending polynomial order — the
    layout ``pydisort`` expects for ``s_poly_coeffs``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if check_inputs:
        if not len(x) > 1:
            raise ValueError("At least 2 points are required.")
        if not len(x) == len(y):
            raise ValueError("The number of x and y points must be equal.")
        if not np.all(np.diff(x) > 0):
            raise ValueError("The x values must be sorted in ascending order.")
    slope = np.diff(y) / np.diff(x)
    intercept = y[:-1] - slope * x[:-1]
    return np.stack([intercept, slope], axis=-1)


def generate_s_poly_coeffs(tau_arr, TEMPER, WVNMLO, WVNMHI, **kwargs):
    """DISORT-equivalent internal-emission polynomials per layer.

    Linear-in-tau interpolation of band-integrated blackbody emission
    between the boundary temperatures ``TEMPER`` (top to bottom,
    ``len == NLayers + 1``).  Kirchhoff emissivity factors ``1 - omega``
    are applied inside the solver, matching Stamnes' DISORT.
    """
    tau_arr = np.atleast_1d(np.asarray(tau_arr, dtype=np.float64))
    TEMPER = np.asarray(TEMPER, dtype=np.float64)
    if not len(TEMPER) == len(tau_arr) + 1:
        raise ValueError(
            "Missing temperature specification at some boundaries / interfaces."
        )
    grid = np.concatenate([[0.0], tau_arr])
    emission = blackbody_contrib_to_BCs(TEMPER, WVNMLO, WVNMHI, **kwargs)
    return linear_spline_coefficients(grid, np.atleast_1d(emission), check_inputs=False)
