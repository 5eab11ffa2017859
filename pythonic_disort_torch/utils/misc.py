"""Small user-facing utilities (host numpy and scipy.sparse).

The port's own copy of ``pythonic_disort_tpu/utils/misc.py``
(capability parity with reference ``subroutines.py``: ``prepend``,
``transform_interval``, ``transform_weights``, ``calculate_nu``,
``atleast_2d_append``, ``generate_FD_mat``, ``to_diag_ordered_form``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


def prepend(arr, arr_len, value):
    """Array of length ``arr_len + 1`` with ``value`` prepended."""
    del arr_len
    return np.concatenate([[value], np.asarray(arr)])


def calculate_nu(mu, phi, mu_p, phi_p):
    """Cosine of the scattering angle between (mu_p, phi_p) and (mu, phi).

    Axes of the (squeezed) result vary with ``mu, phi, mu_p, phi_p``
    respectively.  Reference ``subroutines.py:85-112``.
    """
    mu = np.atleast_1d(mu)
    phi = np.atleast_1d(phi)
    mu_p = np.atleast_1d(mu_p)
    phi_p = np.atleast_1d(phi_p)
    s = np.sqrt(1 - mu**2)[:, None, None, None]
    s_p = np.sqrt(1 - mu_p**2)[None, None, :, None]
    nu = (
        mu_p[None, None, :, None] * mu[:, None, None, None]
        + s_p * s * np.cos(phi_p[None, None, None, :] - phi[None, :, None, None])
    )
    return np.squeeze(nu)


def atleast_2d_append(*arys):
    """Like ``np.atleast_2d`` but appends new axes at the back."""
    res = []
    for ary in arys:
        a = np.asanyarray(ary)
        if a.ndim == 0:
            a = a.reshape(1, 1)
        elif a.ndim == 1:
            a = a[:, None]
        res.append(a)
    return res[0] if len(res) == 1 else res


def generate_FD_mat(Ntau, a, b):
    """Sparse 2nd-order central-difference first-derivative matrix on [a, b]."""
    grid = np.linspace(a, b, Ntau)
    h = grid[1] - grid[0]
    main = np.full(Ntau - 1, 1.0 / (2 * h))
    D = scipy.sparse.diags(main, 1, format="lil")
    D.setdiag(-main, -1)
    D[0, 0], D[0, 1], D[0, 2] = -3 / (2 * h), 2 / h, -1 / (2 * h)
    D[-1, -1], D[-1, -2], D[-1, -3] = 3 / (2 * h), -2 / h, 1 / (2 * h)
    return grid, D.tocsr()


def to_diag_ordered_form(A, Nsuperdiags, Nsubdiags):
    """Matrix -> LAPACK banded (diagonal ordered) storage."""
    n = A.shape[0]
    cols = np.arange(n)
    rows_up = cols[None, :] - np.arange(Nsuperdiags, -1, -1)[:, None]
    rows_dn = cols[None, :] + np.arange(1, Nsubdiags + 1)[:, None]
    out = np.zeros((Nsuperdiags + Nsubdiags + 1, n), dtype=A.dtype)
    for r in range(Nsuperdiags + 1):
        idx = rows_up[r]
        ok = idx >= 0
        out[r, ok] = A[idx[ok], cols[ok]]
    for r in range(Nsubdiags):
        idx = rows_dn[r]
        ok = idx < n
        out[Nsuperdiags + 1 + r, ok] = A[idx[ok], cols[ok]]
    return out


def transform_interval(arr, c, d, a, b):
    """Affine map of points from [a, b] to [c, d]."""
    return (np.asarray(arr) - a) * (d - c) / (b - a) + c


def transform_weights(weights, c, d, a, b):
    """Rescale quadrature weights from [a, b] to [c, d]."""
    return np.asarray(weights) * (d - c) / (b - a)
