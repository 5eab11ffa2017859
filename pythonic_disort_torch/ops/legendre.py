"""Legendre-function building blocks.

Counterpart of ``pythonic_disort_tpu/ops/legendre.py``.

``lam[m, l, i] = sqrt((l-m)!/(l+m)!) P_l^m(x_i)`` without the
Condon-Shortley phase (it cancels in the products ``lam(x_i) lam(x_j)``
the scattering kernels use); entries with ``l < m`` are exactly zero.
`normalized_assoc_legendre` evaluates the table on the device of ``x``
(the single-column solve calls it at the nodes and at ``-mu0`` together);
`normalized_assoc_legendre_host` is its NumPy twin for points known when
a problem is built.  `legendre_series_bcast` evaluates ``sum_l c_l P_l(x)``
by Clenshaw's recurrence, a series per batch element; `legendre_series`
every series at every point.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.profiling import count


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


@functools.lru_cache(maxsize=None)
def _recurrence_tables(nmodes: int, ndeg: int, dtype, device):
    """Per-degree coefficients of the upward recurrence, (ndeg, nmodes, 1):
    ``(2l-1) / d_l``, ``sqrt((l-1)^2 - m^2) / d_l`` with
    ``d_l = sqrt(l^2 - m^2)``, and the masks ``m == l`` and ``m < l``;
    plus the log seed coefficients (nmodes, 1) and the modes (nmodes, 1)."""
    ms = np.arange(nmodes, dtype=np.float64)[None, :, None]
    ell = np.arange(ndeg, dtype=np.float64)[:, None, None]
    denom = np.sqrt(np.maximum(ell**2 - ms**2, 0.0))
    safe_denom = np.where(denom > 0.0, denom, 1.0)
    a = (2.0 * ell - 1.0) / safe_denom
    b = np.sqrt(np.maximum((ell - 1.0) ** 2 - ms**2, 0.0)) / safe_denom
    const = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return (const(a), const(b), const(ms == ell), const(ms < ell),
            const(_seed_log_coeffs(nmodes)[:, None]), const(ms[0]))


def normalized_assoc_legendre(nmodes: int, ndeg: int, x: torch.Tensor) -> torch.Tensor:
    """Table ``lam`` of shape (nmodes, ndeg, npts) on the device of ``x``.

    The same recurrence and seeds as `normalized_assoc_legendre_host`;
    ``x``: (npts,) points in [-1, 1].
    """
    a, b, is_seed, above, log_c, ms = _recurrence_tables(nmodes, ndeg, x.dtype, x.device)
    one_minus_x2 = torch.clamp(1.0 - x[None, :] ** 2, min=0.0)
    positive = one_minus_x2 > 0.0
    safe = torch.where(positive, one_minus_x2, torch.ones_like(one_minus_x2))
    seeds = torch.exp(log_c + 0.5 * ms * torch.log(safe))
    seeds = torch.where(positive | (ms == 0), seeds, torch.zeros_like(seeds))

    prev = torch.zeros_like(seeds)
    prev2 = torch.zeros_like(seeds)
    out = []
    for ell in range(ndeg):
        rec = a[ell] * x[None, :] * prev - b[ell] * prev2
        cur = is_seed[ell] * seeds + above[ell] * rec
        out.append(cur)
        prev2, prev = prev, cur
    return torch.stack(out, dim=1)


def legendre_series(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``f_b(x) = sum_l coeffs[b, l] P_l(x)`` for every series b and point x.

    ``coeffs``: (..., ndeg); ``x``: any shape.  Returns
    ``coeffs.shape[:-1] + x.shape``.
    """
    lead = coeffs.shape[:-1]
    return legendre_series_bcast(coeffs.reshape(lead + (1,) * x.dim() + coeffs.shape[-1:]), x)


def legendre_series_bcast(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_l coeffs[..., l] P_l(x)`` by Clenshaw's recurrence, with
    ``coeffs[..., l]`` broadcast against ``x``: a series per batch element,
    e.g. coeffs (S, L, 1, 1, ndeg) and x (S, 1, K, P) give (S, L, K, P).
    Counts its ``ndeg`` Clenshaw steps as ``legendre_terms`` while a
    profiler runs."""
    ndeg = coeffs.shape[-1]
    count("legendre_terms", ndeg)
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    b1 = torch.zeros(shape, dtype=x.dtype, device=x.device)
    b2 = torch.zeros_like(b1)
    for ell in range(ndeg - 1, -1, -1):
        alpha = (2.0 * ell + 1.0) / (ell + 1.0)
        beta = (ell + 1.0) / (ell + 2.0)
        b1, b2 = coeffs[..., ell] + alpha * x * b1 - beta * b2, b1
    return b1
