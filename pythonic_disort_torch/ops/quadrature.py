"""Quadrature rules (host-side NumPy constants).

The port's own copy of ``pythonic_disort_tpu/ops/quadrature.py``: the
nodes and weights never depend on the solve's inputs, so they are
computed once with NumPy and moved to the device by the caller.
"""

from __future__ import annotations

import numpy as np


def transform_interval(arr, c, d, a=-1.0, b=1.0):
    """Affinely map points from the interval [a, b] onto [c, d]."""
    arr = np.asarray(arr)
    return c + (arr - a) * ((d - c) / (b - a))


def transform_weights(weights, c, d, a=-1.0, b=1.0):
    """Rescale quadrature weights from the interval [a, b] onto [c, d]."""
    weights = np.asarray(weights)
    return weights * ((d - c) / (b - a))


def gauss_legendre(n: int, c: float = 0.0, d: float = 1.0):
    """Gauss-Legendre nodes/weights on [c, d], nodes ascending."""
    x, w = np.polynomial.legendre.leggauss(int(n))
    return transform_interval(x, c, d), transform_weights(w, c, d)


def double_gauss(nquad: int):
    """The double-Gauss rule: ``nquad // 2`` positive nodes on (0, 1)."""
    return gauss_legendre(nquad // 2, 0.0, 1.0)


def clenshaw_curtis(nphi: int, c: float = 0.0, d: float = 2.0 * np.pi):
    """Clenshaw-Curtis nodes/weights on [c, d]; ``nphi`` odd and > 2."""
    if not (nphi > 2 and nphi % 2 == 1):
        raise ValueError("The number of quadrature nodes must be odd and greater than 2.")
    n = nphi - 1
    j = np.arange(n + 1)
    theta = np.pi * j / n
    nodes = -np.cos(theta)

    k = np.arange(n // 2 + 1)
    coeff = 2.0 / (1.0 - 4.0 * k**2)
    terms = coeff[None, :] * np.cos(2.0 * np.outer(theta, k))
    terms[:, 0] *= 0.5
    terms[:, -1] *= 0.5
    w = (2.0 / n) * terms.sum(axis=1)
    w[0] *= 0.5
    w[-1] *= 0.5
    return transform_interval(nodes, c, d), transform_weights(w, c, d)
