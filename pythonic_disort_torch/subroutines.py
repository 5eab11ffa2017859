"""Reference-compatible ``subroutines`` namespace.

The port's counterpart of ``pythonic_disort_tpu/subroutines.py``: users
of the reference import helpers as ``PythonicDISORT.subroutines.<name>``;
this module re-exports the port's equivalent components under the same
names (capability parity with reference ``subroutines.py``).
"""

from .ops.quadrature import (
    gauss_legendre,
    clenshaw_curtis,
)
from .utils.misc import (
    prepend,
    calculate_nu,
    atleast_2d_append,
    generate_FD_mat,
    to_diag_ordered_form,
    transform_interval,
    transform_weights,
)
from .utils.thermal import (
    Planck,
    planck,
    blackbody_contrib_to_BCs,
    linear_spline_coefficients,
    generate_s_poly_coeffs,
)
from .utils.bdrf import (
    generate_emissivity_from_BDRF,
    cache_BDRF_Fourier_modes,
    fourier_modes_from_bdrf,
)
from .utils.actinic import generate_diff_act_flux_funcs
from .utils.interpolate import interpolate
from .utils.compare import _compare, compare
from .models.disort.solve import affine_transform_poly_coeffs


def _mathscr_v(tau, scale_tau, l, Nscoeffs, s_poly_coeffs, G, K,
               G_inv_mu_inv, is_antiderivative_wrt_tau=False,
               autograd_compatible=False):
    """Particular solution for isotropic internal sources (host numpy).

    Compat-namespace counterpart of reference ``subroutines.py:746-862``
    (general-``Nscoeffs`` path; the reference's 1- and 2-coefficient
    special cases are subsumed).  The solver uses the equivalent tensor
    pair ``iso_particular_tensor``/``iso_poly_eval`` in
    `models/disort/solve.py`; this function exists for users who called
    the reference helper directly.

    Shapes: ``tau`` (Ntau,), ``scale_tau`` (NLayers,), ``l`` (Ntau,)
    layer index per tau, ``s_poly_coeffs`` (NLayers, Nscoeffs)
    ascending, ``G`` (NLayers, NQuad, NQuad), ``K`` (NLayers, NQuad),
    ``G_inv_mu_inv`` (NLayers, NQuad).  Returns (NQuad, Ntau).
    """
    import numpy as np
    import warnings as _warnings

    if autograd_compatible:
        import autograd.numpy as np  # noqa: F811 - parity option
    if Nscoeffs > 10:
        _warnings.warn("`Nscoeffs` is large and may cause instability.")

    tau = np.atleast_1d(tau)
    l = np.atleast_1d(l)
    n = Nscoeffs - 1
    K_inv = 1.0 / K
    K_invP = np.cumprod(
        np.broadcast_to(K_inv[:, :, None], K_inv.shape + (Nscoeffs,)), axis=-1
    )
    fact = np.ones(Nscoeffs)
    if Nscoeffs > 1:
        fact[1:] = np.cumprod(np.arange(1, Nscoeffs))
    fact_rev = fact[::-1]
    weighted_a = s_poly_coeffs[:, ::-1] * fact_rev[None, :]
    ii = np.arange(Nscoeffs)[:, None]
    pp = np.arange(Nscoeffs)[None, :]
    lower_tri = np.where(
        (ii - pp >= 0)[None], np.take(weighted_a, ii - pp, axis=1), 0.0
    )
    ub = np.einsum("lkp,lip->lki", K_invP, lower_tri)
    b_right = (ub / fact_rev[None, None, :]) * G_inv_mu_inv[:, :, None]
    mathscr_b = np.einsum("lqk,lki->lqi", G, b_right)    # (NL, NQuad, Ns)

    powers = np.arange(n, -1, -1)[None, :]
    if is_antiderivative_wrt_tau:
        # The reference passes ``scale_tau`` already gathered per tau
        # point (length Ntau); this implementation documents per-layer
        # (length NLayers) shapes.  Accept both: gather when the length
        # matches the layer count (if NLayers == Ntau the per-layer
        # convention wins).
        scale_tau = np.atleast_1d(np.asarray(scale_tau))
        if scale_tau.ndim > 1:              # reference callers pass (Ntau, 1)
            scale_tau = scale_tau.reshape(-1)
        scale_t = scale_tau[l] if scale_tau.shape[0] == K.shape[0] else scale_tau
        p = powers + 1.0
        tau_poly = tau[:, None] ** p / (p * scale_t[:, None])
    else:
        tau_poly = tau[:, None] ** powers
    return np.einsum("tqi,ti->qt", mathscr_b[l], tau_poly)


def Gauss_Legendre_quad(N, c=0, d=1):
    """Gauss-Legendre nodes/weights on [c, d] (reference name)."""
    return gauss_legendre(N, c, d)


def Clenshaw_Curtis_quad(Nphi, c=0.0, d=None):
    """Clenshaw-Curtis nodes/weights on [c, d] (reference name)."""
    import math

    if d is None:
        d = 2 * math.pi
    return clenshaw_curtis(Nphi, c, d)


__all__ = [
    "Gauss_Legendre_quad", "Clenshaw_Curtis_quad", "gauss_legendre",
    "clenshaw_curtis", "prepend", "calculate_nu", "atleast_2d_append",
    "generate_FD_mat", "to_diag_ordered_form", "transform_interval",
    "transform_weights", "Planck", "planck", "blackbody_contrib_to_BCs",
    "linear_spline_coefficients", "generate_s_poly_coeffs",
    "generate_emissivity_from_BDRF", "cache_BDRF_Fourier_modes",
    "fourier_modes_from_bdrf", "generate_diff_act_flux_funcs",
    "interpolate", "_compare", "compare",
    "affine_transform_poly_coeffs", "_mathscr_v",
]
