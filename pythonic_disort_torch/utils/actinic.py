"""Actinic-flux functions from the zeroth intensity mode.

The port's own copy of ``pythonic_disort_tpu/utils/actinic.py``
(capability parity: reference ``subroutines.py:258-318``).  Wraps the
``u0`` closure returned by ``pydisort`` into upward/downward diffuse
actinic-flux functions; the downward one adds the delta-M
reclassification of the direct beam, which the closure returns under
``_return_act_dscale_for_reclass=True``.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.quadrature import double_gauss


def generate_diff_act_flux_funcs(u0):
    """Return ``(flux_act_up, flux_act_down_diffuse)`` closures."""
    N = len(u0(0)) // 2
    _, W = double_gauss(2 * N)

    def flux_act_up(tau, is_antiderivative_wrt_tau=False, return_tau_arr=False):
        if return_tau_arr:
            u0_cache, tau_arr = u0(tau, is_antiderivative_wrt_tau, True)
            return np.squeeze(2 * math.pi * W @ u0_cache[:N])[()], tau_arr
        return np.squeeze(
            2 * math.pi * W @ u0(tau, is_antiderivative_wrt_tau)[:N]
        )[()]

    def flux_act_down_diffuse(
        tau, is_antiderivative_wrt_tau=False, return_tau_arr=False
    ):
        if return_tau_arr:
            u0_cache, tau_arr, reclass = u0(
                tau, is_antiderivative_wrt_tau, True,
                _return_act_dscale_for_reclass=True,
            )
            base = 2 * math.pi * W @ u0_cache[N:]
            return np.squeeze(base + reclass)[()], tau_arr
        u0_cache, reclass = u0(
            tau, is_antiderivative_wrt_tau, False,
            _return_act_dscale_for_reclass=True,
        )
        base = 2 * math.pi * W @ u0_cache[N:]
        return np.squeeze(base + reclass)[()]

    return flux_act_up, flux_act_down_diffuse
