"""Normalized associated Legendre functions, evaluated on the host.

``lam[m, l, i] = sqrt((l-m)!/(l+m)!) P_l^m(x_i)`` without the
Condon-Shortley phase (it cancels in the products ``lam(x_i) lam(x_j)``
the scattering kernels use); entries with ``l < m`` are exactly zero.
Port of ``normalized_assoc_legendre_host`` in
``pythonic_disort_tpu/ops/legendre.py``.
"""

from __future__ import annotations

import numpy as np


def _seed_log_coeffs(nmodes: int) -> np.ndarray:
    """log of |lam_m^m| prefactors: sqrt(prod_{k=1..m} (2k-1)/(2k))."""
    m = np.arange(nmodes)
    with np.errstate(divide="ignore"):
        ratios = np.concatenate([[0.0], np.log(2.0 * m[1:] - 1.0) - np.log(2.0 * m[1:])])
    return 0.5 * np.cumsum(ratios)


def normalized_assoc_legendre_host(nmodes: int, ndeg: int, x) -> np.ndarray:
    """Table ``lam`` of shape (nmodes, ndeg, npts), float64.

    Degree-upward recurrence
    ``sqrt((l+1)^2 - m^2) lam_{l+1} = (2l+1) x lam_l - sqrt(l^2 - m^2) lam_{l-1}``
    seeded at ``lam_m^m(x) = sqrt(prod_{k<=m} (2k-1)/(2k)) (1-x^2)^{m/2}``.
    """
    x = np.asarray(x, np.float64)
    npts = x.shape[0]
    ms = np.arange(nmodes, dtype=np.float64)[:, None]
    log_c = _seed_log_coeffs(nmodes)[:, None]
    one_minus_x2 = np.maximum(1.0 - x[None, :] ** 2, 0.0)
    safe = np.where(one_minus_x2 > 0.0, one_minus_x2, 1.0)
    seeds = np.exp(log_c + 0.5 * ms * np.log(safe))
    seeds = np.where((one_minus_x2 > 0.0) | (ms == 0), seeds, 0.0)

    out = np.zeros((nmodes, ndeg, npts))
    prev = np.zeros((nmodes, npts))
    prev2 = np.zeros((nmodes, npts))
    for ell in range(ndeg):
        denom = np.sqrt(np.maximum(float(ell) ** 2 - ms**2, 0.0))
        safe_denom = np.where(denom > 0.0, denom, 1.0)
        rec = (
            (2.0 * ell - 1.0) * x[None, :] * prev
            - np.sqrt(np.maximum((ell - 1.0) ** 2 - ms**2, 0.0)) * prev2
        ) / safe_denom
        cur = np.where(ms == ell, seeds, np.where(ms < ell, rec, 0.0))
        out[:, ell] = cur
        prev2, prev = prev, cur
    return out
