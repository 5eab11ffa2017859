"""Golden-file comparison harness against Stamnes' DISORT outputs.

The port's own copy of ``pythonic_disort_tpu/utils/compare.py`` (numpy
only).  Capability parity: reference ``subroutines.py:866-976``
(``_compare``).
Golden ``.npz`` files hold ``flup``, ``rfldn``, ``rfldir``, ``uu`` plus
probe grids ``tau_test_arr`` / ``phi_arr``; this computes max pointwise
absolute differences and difference ratios for the three fluxes and
(optionally) the intensity, returning them for test assertions.
"""

from __future__ import annotations

import numpy as np


def _ratio(diff, ref):
    return np.divide(diff, ref, out=np.zeros_like(diff), where=ref != 0)


def compare(results, mu_to_compare, reorder_mu, flux_up, flux_down, u=None,
            verbose=True):
    flup = results["flup"]
    rfldn = results["rfldn"]
    rfldir = results["rfldir"]
    tau_test_arr = results["tau_test_arr"]

    fd_diffuse, fd_direct = flux_down(tau_test_arr)[:2]
    diff_flux_up = np.abs(flup - flux_up(tau_test_arr))
    ratio_flux_up = _ratio(diff_flux_up, flup)
    diff_flux_down_diffuse = np.abs(rfldn - fd_diffuse)
    ratio_flux_down_diffuse = _ratio(diff_flux_down_diffuse, rfldn)
    diff_flux_down_direct = np.abs(rfldir - fd_direct)
    ratio_flux_down_direct = _ratio(diff_flux_down_direct, rfldir)

    if verbose:
        print("Max pointwise differences vs Stamnes DISORT")
        print(f"  flux_up:          diff {diff_flux_up.max():.3e}  ratio {ratio_flux_up.max():.3e}")
        print(f"  flux_down (diff): diff {diff_flux_down_diffuse.max():.3e}  ratio {ratio_flux_down_diffuse.max():.3e}")
        print(f"  flux_down (dir):  diff {diff_flux_down_direct.max():.3e}  ratio {ratio_flux_down_direct.max():.3e}")

    outputs = (
        diff_flux_up, ratio_flux_up,
        diff_flux_down_diffuse, ratio_flux_down_diffuse,
        diff_flux_down_direct, ratio_flux_down_direct,
    )
    if u is None:
        return outputs

    uu = results["uu"]
    phi_arr = results["phi_arr"]
    u_cache = u(tau_test_arr, phi_arr)[reorder_mu].reshape(np.shape(uu))
    diff = np.abs(uu - u_cache)[mu_to_compare]
    diff_ratio = _ratio(diff, np.abs(uu[mu_to_compare]))
    if verbose:
        print(f"  intensity:        diff {diff.max():.3e}  ratio {diff_ratio.max():.3e}")
    return outputs + (diff, diff_ratio)


# Reference-compatible alias
_compare = compare
