"""The port's absolute float64 accuracy against the 50-digit mpmath oracle.

The counterpart of ``tests/test_oracle.py::test_absolute_accuracy_vs_oracle``:
the port's ``pydisort`` (float64, on the CPU) at the same cases and bounds,
against ``tests/oracle.py``, which solves the same discrete system (the
double-Gauss nodes and weights as float64 inputs) in 50-digit arithmetic.
"""

import warnings

import numpy as np
import pytest
import torch

from pythonic_disort_tpu.ops.quadrature import double_gauss as jax_double_gauss

import pythonic_disort_torch as pt
from pythonic_disort_torch.ops.quadrature import double_gauss
from oracle import oracle_fluxes
from test_oracle import CASES

NQUAD = 16


def test_oracle_nodes_are_the_ports():
    """The oracle takes the JAX package's nodes and weights; the port's are the same."""
    for a, b in zip(double_gauss(NQUAD), jax_double_gauss(NQUAD)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_absolute_accuracy_vs_oracle(name):
    tau0, omega, bound = CASES[name]
    leg = np.zeros(NQUAD + 1)
    leg[0] = 1.0
    mu0, I0 = 0.1, np.pi / 0.1
    tau_eval = np.linspace(0, tau0, 5)

    exact = oracle_fluxes(tau0, omega, NQUAD, leg, mu0, I0, tau_eval)
    ex_fu = np.array([float(e[0]) for e in exact])
    ex_fd = np.array([float(e[1]) for e in exact])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, flux_up, flux_down, _, _ = pt.pydisort(tau0, omega, NQUAD, leg, mu0, I0, 0.0, dtype=torch.float64,
                                                  device="cpu")
    err_up = np.abs(np.asarray(flux_up(tau_eval)) - ex_fu).max()
    err_down = np.abs(np.asarray(flux_down(tau_eval)[0]) - ex_fd).max()
    assert err_up < bound, f"{name}: flux_up {err_up:.3e} against the bound {bound:g}"
    assert err_down < bound, f"{name}: flux_down {err_down:.3e} against the bound {bound:g}"
