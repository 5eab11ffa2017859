"""Polynomial interpolation of intensity to off-quadrature polar angles.

The port's own copy of ``pythonic_disort_tpu/utils/interpolate.py``
(capability parity with reference ``subroutines.py:614-705``): wraps a
``u`` / ``u0`` closure of ``pydisort`` (``models/disort/closures.py``,
numpy out) into one accepting arbitrary ``mu`` in [-1, 1], interpolating
per hemisphere through the Gauss nodes with the closed-form barycentric
weights (host numpy; no SciPy interpolator).
"""

from __future__ import annotations

import numpy as np

from ..ops.quadrature import double_gauss


def barycentric_weights(nodes):
    """First-form barycentric weights ``w_j = 1/prod_{k!=j}(x_j - x_k)``."""
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / diff.prod(axis=1)


def barycentric_eval(nodes, weights, values, x):
    """Evaluate the interpolating polynomial at ``x``.

    ``values``: (Nnodes, ...) data at nodes; ``x``: (Nx,).  Exact at
    nodes (handled by direct substitution).  Returns (Nx, ...).
    """
    x = np.atleast_1d(x)
    dx = x[:, None] - nodes[None, :]               # (Nx, Nn)
    exact = dx == 0.0
    safe_dx = np.where(exact, 1.0, dx)
    c = weights[None, :] / safe_dx                 # (Nx, Nn)
    denom = c.sum(axis=1)
    extra = values.shape[1:]
    num = np.tensordot(c, values, axes=(1, 0))     # (Nx, ...)
    out = num / denom.reshape((-1,) + (1,) * len(extra))
    hit = exact.any(axis=1)
    if np.any(hit):
        idx = exact.argmax(axis=1)
        out[hit] = values[idx[hit]]
    return out


def interpolate(u):
    """Wrap a ``u(tau, phi)`` or ``u0(tau)`` closure with mu interpolation.

    The returned function takes ``(mu, tau[, phi], ...)`` and
    interpolates each hemisphere's quadrature values polynomially,
    dispatching on the wrapped closure's arity like the reference.
    """
    import inspect

    params = list(inspect.signature(u).parameters)
    is_full_u = "phi" in params or len(params) >= 5
    probe = u(0, 0) if is_full_u else u(0)
    N = len(np.atleast_1d(probe)) // 2
    mu_pos, _ = double_gauss(2 * N)
    w_pos = barycentric_weights(mu_pos)
    w_neg = barycentric_weights(-mu_pos)

    def _interp(mu, u_cache):
        mu = np.atleast_1d(mu)
        if not np.all(np.abs(mu) <= 1):
            raise ValueError("mu values must be between -1 and 1.")
        u_cache = np.asarray(u_cache)
        if u_cache.ndim == 1:
            u_cache = u_cache[:, None]
            squeeze = True
        else:
            squeeze = False
        res = np.empty((len(mu),) + u_cache.shape[1:])
        pos = mu > 0
        if np.any(pos):
            res[pos] = barycentric_eval(mu_pos, w_pos, u_cache[:N], mu[pos])
        if np.any(~pos):
            res[~pos] = barycentric_eval(-mu_pos, w_neg, u_cache[N:], mu[~pos])
        return np.squeeze(res)[()] if squeeze else res

    if is_full_u:
        def u_interpol(mu, tau, phi, is_antiderivative_wrt_tau=False,
                       return_Fourier_error=False, return_tau_arr=False):
            if return_Fourier_error or return_tau_arr:
                outs = u(tau, phi, is_antiderivative_wrt_tau,
                         return_Fourier_error, return_tau_arr)
                return (np.squeeze(_interp(mu, outs[0]))[()],) + outs[1:]
            return np.squeeze(_interp(mu, u(tau, phi, is_antiderivative_wrt_tau)))[()]
    else:
        def u_interpol(mu, tau, is_antiderivative_wrt_tau=False,
                       return_Fourier_error=False, return_tau_arr=False):
            if return_tau_arr:
                outs = u(tau, is_antiderivative_wrt_tau, True)
                return (np.squeeze(_interp(mu, outs[0]))[()],) + outs[1:]
            return np.squeeze(_interp(mu, u(tau, is_antiderivative_wrt_tau)))[()]

    return u_interpol
