"""The Stamnes goldens through the port's ``pydisort`` (CPU, float64).

All 35 argument sets of ``tests/test_stamnes.py`` and
``tests/test_stamnes_sources.py`` go through
``pythonic_disort_torch.pydisort`` with ``device="cpu"`` (the plain
versions of the kernels) and are held to the reference thresholds of
``tests/helpers.py`` against the golden files in ``tests/data/stamnes``:
flux relative error < 1e-3 wherever |diff| > 1e-3, intensity relative
error < 1e-2 wherever |diff| > 1e-3.  No JAX solve runs here; the JAX
package only supplies the case definitions.
"""

from math import pi

import numpy as np
import pytest
import torch

import pythonic_disort_torch as pt
from pythonic_disort_torch.utils.compare import compare
from helpers import load_golden
from test_stamnes import CASES as CASES_A
from test_stamnes_sources import CASES as CASES_B

CASES = {**CASES_A, **CASES_B}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_all_35_goldens_are_covered():
    assert len(CASES) == 35


@pytest.mark.parametrize("name", sorted(CASES))
def test_stamnes_case_through_the_port(name):
    case = CASES[name]() if callable(CASES[name]) else CASES[name]
    kwargs = case["kwargs"]
    outputs = pt.pydisort(**kwargs, device="cpu")
    mu_arr, flux_up, flux_down = outputs[:3]
    u = outputs[4] if (case.get("intensity", True) and len(outputs) > 4) else None

    reorder_mu = np.argsort(mu_arr)
    away = np.abs(np.arccos(np.abs(mu_arr[reorder_mu])) - np.arccos(kwargs["mu0"])) * 180 / pi
    out = compare(load_golden(name), away > case.get("deg_around_beam", 0), reorder_mu,
                  flux_up, flux_down, u, verbose=False)
    dfu, rfu, dfdd, rfdd, dfdr, rfdr = out[:6]
    assert np.max(rfu[dfu > 1e-3], initial=0) < 1e-3, "flux_up mismatch"
    assert np.max(rfdd[dfdd > 1e-3], initial=0) < 1e-3, "flux_down diffuse mismatch"
    assert np.max(rfdr[dfdr > 1e-3], initial=0) < 1e-3, "flux_down direct mismatch"
    if u is not None:
        diff, diff_ratio = out[6], out[7]
        assert np.max(diff_ratio[diff > 1e-3], initial=0) < 1e-2, "intensity mismatch"
