"""Randomized feature-matrix parity of the port against the JAX package
(CPU, float64).

``tests/test_random_parity.py``'s matrix (beam x iso source x BDRF x
delta-M on randomized five-layer atmospheres with layer-varying omega, g
and f; seeds 11 and 29; NQuad = 16) held against the upstream reference
skips without it; here the same cases go through the port's ``pydisort``
and the JAX package's, and the ``everything`` row also through the port's
batched path, both seeds in one batch.  Delta-M bugs tied to layer-varying
omega and f are invisible to the golden files, whose albedo is uniform per
case.  One shape throughout, so JAX compiles once per feature row.
"""

import warnings

import numpy as np
import pytest
import torch

import pythonic_disort_tpu as pdt

import pythonic_disort_torch as pt
from test_random_parity import FEATURES, NLA, NQ, L, _case

SEEDS = (11, 29)
PHI = np.array([0.4, 3.9])


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _probes(kwargs):
    return np.linspace(0, float(kwargs["tau_arr"][-1]), 13) * (1 - 1e-12)


def _jax_outputs(kwargs):
    """Fluxes (up, down diffuse, down direct) and u of the JAX package."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = pdt.pydisort(**kwargs)
    tau = _probes(kwargs)
    return [np.asarray(out[1](tau)), *(np.asarray(x) for x in out[2](tau)), np.asarray(out[4](tau, PHI))]


def _close(ours, ref, label):
    """rtol 1e-10 on fluxes and 1e-9 on u, with absolute floors of 1e-12
    and 1e-10 of the largest value for entries near zero (u's roundoff
    there is about 2e-12 of its largest value)."""
    fscale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max(), 1e-12)
    for lbl, o, r in zip(("flux_up", "flux_down", "flux_dir"), ours[:3], ref[:3]):
        np.testing.assert_allclose(o, r, rtol=1e-10, atol=1e-12 * fscale, err_msg=f"{label}: {lbl}")
    np.testing.assert_allclose(ours[3], ref[3], rtol=1e-9, atol=1e-10 * max(np.abs(ref[3]).max(), 1e-12),
                               err_msg=f"{label}: intensity")


@pytest.mark.parametrize("name,beam,iso,bdrf,deltam", FEATURES, ids=[f[0] for f in FEATURES])
@pytest.mark.parametrize("seed", SEEDS)
def test_random_feature_parity(name, beam, iso, bdrf, deltam, seed):
    kwargs = _case(seed, beam, iso, bdrf, deltam)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = pt.pydisort(**kwargs, device="cpu")
    tau = _probes(kwargs)
    _close([ours[1](tau), *ours[2](tau), ours[4](tau, PHI)], _jax_outputs(kwargs), f"{name}/seed{seed}")


def test_everything_row_batched():
    """Both seeds' ``everything`` atmospheres in one batched solve
    (``make_batched_problem``, ``solve_batched``, ``fluxes_at``, ``u_at``)
    against the JAX package's single-column ``pydisort``."""
    name, beam, iso, bdrf, deltam = next(f for f in FEATURES if f[0] == "everything")
    cases = [_case(seed, beam, iso, bdrf, deltam) for seed in SEEDS]
    S, N = len(cases), NQ // 2
    cfg = pt.DisortConfig(nquad=NQ, nleg=NQ, nleg_all=NLA, nfourier=NQ, nlayers=L, nscoeffs=2, nbdrf=1,
                          has_beam=True, only_flux=False, has_deltam=True)
    stack = lambda key: np.stack([np.asarray(c[key], np.float64) for c in cases])
    boundary = lambda key: np.stack([np.pad(np.full((N, 1), c[key]), ((0, 0), (0, NQ - 1))) for c in cases])
    albedo = np.array([c["BDRF_Fourier_modes"][0](np.ones(1), np.ones(1))[0, 0] for c in cases])
    prob = pt.make_batched_problem(
        cfg, stack("tau_arr"), stack("omega_arr"), stack("Leg_coeffs_all"), stack("mu0"), stack("I0"),
        phi0=stack("phi0"), f_arr=stack("f_arr"), b_pos=boundary("b_pos"), b_neg=boundary("b_neg"),
        s_poly_coeffs=stack("s_poly_coeffs"),
        bdrf_modes=np.broadcast_to(albedo[:, None, None, None], (S, 1, N, N)),
        bdrf_modes_mu0=np.broadcast_to(albedo[:, None, None], (S, 1, N)),
        dtype=torch.float64, device="cpu")
    sol = pt.solve_batched(prob)
    tau = np.stack([_probes(c) for c in cases])
    fluxes = [x.numpy() for x in pt.fluxes_at(sol, tau)]
    u = pt.u_at(sol, tau, np.tile(PHI, (S, 1))).numpy()
    for i, (seed, kwargs) in enumerate(zip(SEEDS, cases)):
        _close([f[i] for f in fluxes] + [u[i]], _jax_outputs(kwargs), f"batched {name}/seed{seed}")
