"""Planck band integration on the device, for spectral sweeps.

Counterpart of ``pythonic_disort_tpu/ops/planck.py``.  The host helpers
(``utils/thermal.py``) use adaptive quadrature; this is the device route:
fixed-order Gauss-Legendre panels over wavenumber, evaluated as tensor
code on the device of the temperatures and differentiable through
``torch.autograd`` in the temperatures and optical depths.  Replaces the
role of ``scipy.integrate.quad_vec`` in reference
``subroutines.py:354-377,448``.

The Planck integrand in wavenumber is smooth but sharply peaked near
``wv_peak ~ 1.93 T`` (wavenumber in cm^-1 when ``T`` in kelvin); for
wide bands a uniform panel split under-resolves the peak, so panels are
placed on a geometric grid anchored at the band's top.  A band's nodes
and weights are built on the host and copied to the device once, then
kept there (``_band_rule``): a sweep calls the route with the same bands
chunk after chunk, and each copy from pageable memory blocks the host.

A tensor argument runs on its own device; other arguments go to the
device of a tensor argument, else to ``cuda`` unless ``device="cpu"`` is
given (``parallel/batch.py::_device``).
"""

from __future__ import annotations

import threading

import numpy as np
import scipy.constants as const
import torch

from ..parallel.batch import _device
from ..utils.profiling import count, from_host, span

_C2 = 100.0 * const.h * const.c / const.k        # second radiation constant x100
_PREF = 2e8 * const.h * const.c**2


def _tensors(*xs, device=None):
    """``xs`` as tensors: tensors as they are, the rest (numpy, numbers;
    integers as float64) on the first tensor's device, else on
    ``_device(device)``."""
    on = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if on is None:
        on = _device(device)
    out = []
    for x in xs:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            x = from_host(torch.as_tensor(x if np.issubdtype(x.dtype, np.floating) else x.astype(np.float64),
                                          device=on))
        out.append(x)
    return out


def planck(T, wvnm, device=None):
    """Blackbody emission W/m^2 at temperature T [K], wavenumber [m^-1].

    Overflow-safe; matches ``utils.thermal.planck``.  Zero where T <= 0,
    through a double ``torch.where`` (the divisor is 1 there), so the
    gradient stays finite at every T.
    """
    T, wv = _tensors(T, wvnm, device=device)
    if not isinstance(wvnm, (int, float)):     # a Python number keeps T's dtype
        wvnm = wv
    pos = T > 0
    x = _C2 * wvnm / torch.where(pos, T, torch.ones_like(T))
    e = torch.exp(-x)
    val = _PREF * wvnm**3 * e / (1.0 - e)
    return torch.where(pos, val, torch.zeros_like(val))


def _panel_rule(lo, hi, order, panels):
    """Gauss-Legendre nodes and weights (host float64) of ``panels``
    geometric panels over [lo, hi], denser toward the low end."""
    x, w = np.polynomial.legendre.leggauss(order)
    edges = np.unique(np.concatenate([[lo], np.geomspace(max(lo, hi * 1e-4), hi, panels), [hi]]))
    edges = edges[(edges >= lo) & (edges <= hi)]
    if edges[0] > lo:
        edges = np.concatenate([[lo], edges])
    if edges[-1] < hi:
        edges = np.concatenate([edges, [hi]])
    a, b = edges[:-1, None], edges[1:, None]
    return (0.5 * (b - a) * x + 0.5 * (a + b)).ravel(), (0.5 * (b - a) * w).ravel()


_RULES_MAX = 256
_RULES = {}                 # (lo, hi, order, panels, dtype, device) -> (nodes, weights), oldest first
_RULES_LOCK = threading.Lock()


def _band_rule(lo, hi, order, panels, dtype, device):
    """`_panel_rule`'s nodes and weights in ``dtype`` on ``device``, built
    and copied on the first call with these arguments and kept: at most
    ``_RULES_MAX`` rules, the oldest dropped first.

    Built outside inference mode, so that a rule first asked for under
    ``torch.inference_mode`` can still be saved for a backward pass.
    Counts ``planck_rule_hits`` or ``planck_rule_builds``.
    """
    key = (lo, hi, order, panels, dtype, device)
    rule = _RULES.get(key)
    if rule is not None:
        count("planck_rule_hits")
        return rule
    count("planck_rule_builds")
    nodes, weights = _panel_rule(lo, hi, order, panels)
    with torch.inference_mode(False):
        rule = (from_host(torch.as_tensor(nodes, dtype=dtype, device=device)),
                from_host(torch.as_tensor(weights, dtype=dtype, device=device)))
    with _RULES_LOCK:
        if key not in _RULES and len(_RULES) >= _RULES_MAX:
            del _RULES[next(iter(_RULES))]
        _RULES[key] = rule
    return rule


def band_integrated_emission(T, wvnmlo, wvnmhi, order=32, panels=8, device=None):
    """Integral of ``planck(T, .)`` over [wvnmlo, wvnmhi].

    T may be any shape (broadcast against the quadrature grid); the band
    edges are Python floats.  The nodes and weights, in T's dtype on T's
    device, come from `_band_rule`.
    """
    with span("disort.planck.emission"):
        (T,) = _tensors(T, device=device)
        lo, hi = float(wvnmlo), float(wvnmhi)
        if hi <= lo:
            return torch.zeros_like(T)
        with span("disort.planck.rule"):
            nodes, weights = _band_rule(lo, hi, order, panels, T.dtype, T.device)
        return torch.sum(planck(T[..., None], nodes) * weights, dim=-1)


def s_poly_coeffs_from_temper(tau_arr, temper, wvnmlo, wvnmhi, device=None, **quad_kw):
    """DISORT-style linear source polynomials from a temperature profile
    (device counterpart of ``utils.thermal.generate_s_poly_coeffs``).

    ``tau_arr``: (..., L), ``temper``: (..., L+1).  Returns (..., L, 2)
    ascending-order coefficients ``[intercept, slope]``.
    """
    tau_arr, temper = _tensors(tau_arr, temper, device=device)
    emission = band_integrated_emission(temper, wvnmlo, wvnmhi, **quad_kw)
    grid = torch.cat([torch.zeros_like(tau_arr[..., :1]), tau_arr], dim=-1)
    slope = torch.diff(emission, dim=-1) / torch.diff(grid, dim=-1)
    intercept = emission[..., :-1] - slope * grid[..., :-1]
    return torch.stack([intercept, slope], dim=-1)
