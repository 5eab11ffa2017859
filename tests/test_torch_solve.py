"""The port's single-column ``solve`` held against the JAX package (CPU,
float64).

The problems are the single-column equivalents of
``tests/test_batch_solve.py::CASES`` (beam, isotropic source with 1 and 3
polynomial coefficients, delta-M with layer-varying omega and f, BDRF,
L = 1 and L = 4, NQuad = 8): column ``s`` of the batched JAX problem,
made from a numpy seed, goes through both packages' ``solve``.  On CPU
tensors the port runs the plain versions of its kernels; the JAX package
its plain jnp paths.  The eigen columns may come out in another order,
and the boundary-value coefficients adapt to it, so the comparisons are
of fields that do not depend on that order, and of everything the
evaluators read from the solution.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pythonic_disort_tpu.models.disort import eval as jev
from pythonic_disort_tpu.models.disort import solve as jsolve

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import eval as ev
from pythonic_disort_torch.models.disort import solve as psolve
from pythonic_disort_torch.ops import legendre
from test_batch_solve import CASES, _problem


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def column(problem, s, nscoeffs=None):
    """Column ``s`` of a batched JAX problem as a JAX problem and the port's."""
    leaves = {f.name: getattr(problem, f.name) for f in dataclasses.fields(problem) if f.name != "config"}
    leaves = {k: None if v is None else np.asarray(v)[s] for k, v in leaves.items()}
    leaves["lam_mu0"] = None        # both packages evaluate the table at -mu0 themselves
    cfg = problem.config
    if nscoeffs is not None:
        cfg = dataclasses.replace(cfg, nscoeffs=nscoeffs)
        leaves["s_poly_coeffs"] = leaves["s_poly_coeffs"][:, :nscoeffs]
    jprob = type(problem)(config=cfg, **{k: None if v is None else jnp.asarray(v) for k, v in leaves.items()})
    return jprob, pt.problem_from_arrays(dataclasses.asdict(cfg), leaves, "cpu", torch.float64)


def close(a, b, label):
    # f64 on both sides; roundoff grown by the conditioning of the
    # boundary-value system stays well inside 1e-9
    a = np.asarray(a)
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12 * max(np.abs(a).max(), 1e-300), err_msg=label)


SOLVE_CASES = [(*c, None) for c in CASES] + [
    (4, 1, False, True, False, False, True, 1),     # iso source, one coefficient
    (4, 2, True, True, True, True, False, 1),       # everything, one coefficient
]


@pytest.mark.parametrize("nlayers,nfourier,beam,iso,bdrf,deltam,only_flux,nscoeffs", SOLVE_CASES)
def test_solve_matches_jax(nlayers, nfourier, beam, iso, bdrf, deltam, only_flux, nscoeffs):
    batched, tau = _problem(nlayers, nfourier, beam, iso, bdrf, deltam, only_flux)
    jprob, pprob = column(batched, 1, nscoeffs)
    ref = jax.jit(jsolve.solve)(jprob)
    sol = pt.solve(pprob)
    out = pt.solution_to_arrays(sol)

    np.testing.assert_allclose(np.sort(out["K"], -1), np.sort(np.asarray(ref.K), -1), rtol=1e-10)
    for f in ("B", "mathscr_b", "fb_up", "fb_dn", "fi_up", "fi_dn", "rescale_factor", "I0",
              "scaled_tau_with_0", "scale_tau", "scaled_omega_arr", "weighted_leg_all", "weighted_scaled_leg"):
        close(getattr(ref, f), out[f], f)
    # summed over the eigen columns, the flux tables do not depend on their order
    for f in ("fvec_up", "fvec_dn"):
        close(np.asarray(getattr(ref, f)).sum(-1), out[f].sum(-1), f)
    assert out["G"].shape == np.asarray(ref.G).shape and out["GC"].shape == np.asarray(ref.GC).shape

    t = np.concatenate([[0.0], tau[1] * 0.4, tau[1]])
    phi = np.array([0.0, 0.7, 3.0])
    tt, pp = torch.as_tensor(t), torch.as_tensor(phi)
    jt, jp = jnp.asarray(t), jnp.asarray(phi)
    for anti in (False, True):
        close(jev.flux_up(ref, jt, anti), ev.flux_up(sol, tt, anti).numpy(), f"flux_up anti={anti}")
        for lbl, a, b in zip(("diffuse", "direct"), jev.flux_down(ref, jt, anti), ev.flux_down(sol, tt, anti)):
            close(a, b.numpy(), f"flux_down {lbl} anti={anti}")
        close(jev.u0(ref, jt, anti), ev.u0(sol, tt, anti).numpy(), f"u0 anti={anti}")
        close(jev.act_dscale_reclassification(ref, jt, anti),
              ev.act_dscale_reclassification(sol, tt, anti).numpy(), f"act_dscale anti={anti}")
        a, fa = jev.u(ref, jt, jp, anti, True)
        b, fb = ev.u(sol, tt, pp, anti, True)
        close(a, b.numpy(), f"u anti={anti}")
        np.testing.assert_allclose(float(fb), float(fa), rtol=1e-6, atol=1e-12, err_msg="Fourier error")
        close(a, ev.u(sol, tt, pp, anti).numpy(), f"u without the Fourier error, anti={anti}")


def test_evaluators_take_batched_and_single_column_solutions():
    """A single-column solution stacked into a batch of two evaluates to the
    stack of the single-column results."""
    batched, tau = _problem(*CASES[6])
    sols = [pt.solve(column(batched, s)[1]) for s in (0, 2)]
    fields = [pt.solution_to_arrays(s) for s in sols]
    stacked = dataclasses.replace(sols[0], **{
        k: torch.as_tensor(np.stack([f[k] for f in fields])) for k in fields[0]})
    t = torch.as_tensor(np.stack([tau[0], tau[2]]) * 0.8)
    phi = torch.as_tensor([[0.0, 1.0], [2.0, 3.0]])
    both = ev.u(stacked, t, phi)
    assert both.shape == (2, 8, 4, 2)
    for i, s in enumerate(sols):
        torch.testing.assert_close(both[i], ev.u(s, t[i], phi[i]), rtol=1e-13, atol=1e-15)
        torch.testing.assert_close(ev.u0(stacked, t)[i], ev.u0(s, t[i]), rtol=1e-13, atol=1e-15)
        for a, b in zip(ev.fluxes_all(stacked, t), ev.fluxes_all(s, t[i])):
            torch.testing.assert_close(a[i], b, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_affine_transform_poly_coeffs_matches_jax(nc):
    rng = np.random.default_rng(nc)
    coeffs = rng.standard_normal((2, 5, nc))
    a = rng.uniform(0.3, 1.0, (2, 5))
    b = rng.uniform(-2.0, 2.0, (2, 5))          # negative shifts included
    b[0, 0] = 0.0
    ref = np.asarray(jsolve.affine_transform_poly_coeffs(jnp.asarray(coeffs), jnp.asarray(a), jnp.asarray(b)))
    out = psolve.affine_transform_poly_coeffs(*(torch.as_tensor(x) for x in (coeffs, a, b))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)
    # the defining identity: sum_i D_i y^i = sum_i C_i x^i at y = a x + b
    x = 0.37
    y = a * x + b
    np.testing.assert_allclose(np.sum(out * y[..., None] ** np.arange(nc), -1),
                               np.sum(coeffs * x ** np.arange(nc), -1), rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("anti", [False, True])
def test_iso_poly_eval_matches_jax(ns, anti):
    rng = np.random.default_rng(10 + ns)
    b_rows = rng.standard_normal((6, 4, ns))
    tau = np.array([0.0, 0.0, 0.5, 1.0, 2.5, 7.0])     # tau = 0 included
    scale = rng.uniform(0.5, 1.0, 6)
    ref = np.asarray(jsolve.iso_poly_eval(jnp.asarray(b_rows), jnp.asarray(tau), jnp.asarray(scale), anti))
    out = psolve.iso_poly_eval(*(torch.as_tensor(x) for x in (b_rows, tau, scale)), anti).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-15)


def test_iso_particular_tensor_matches_jax():
    rng = np.random.default_rng(4)
    L, n2, ns = 3, 6, 3
    G0 = rng.standard_normal((L, n2, n2))
    K0 = rng.uniform(0.5, 3.0, (L, n2)) * np.where(np.arange(n2) < n2 // 2, -1, 1)
    gim = rng.standard_normal((L, n2))
    s_desc = rng.standard_normal((L, ns))
    ref = np.asarray(jsolve.iso_particular_tensor(*(jnp.asarray(x) for x in (G0, K0, gim, s_desc))))
    out = psolve.iso_particular_tensor(*(torch.as_tensor(x) for x in (G0, K0, gim, s_desc))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)


def test_device_legendre_tables_match_jax():
    from pythonic_disort_tpu.ops import legendre as jleg

    x = np.array([-1.0, -0.73, -0.2, 0.0, 0.31, 0.9, 1.0])
    ref = np.asarray(jleg.normalized_assoc_legendre(5, 9, jnp.asarray(x)))
    out = legendre.normalized_assoc_legendre(5, 9, torch.as_tensor(x)).numpy()
    # the same recurrence with the division folded into its coefficients
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(out, legendre.normalized_assoc_legendre_host(5, 9, x), rtol=1e-13, atol=1e-15)
    coeffs = np.random.default_rng(0).standard_normal((2, 3, 12))
    pts = np.linspace(-1, 1, 10).reshape(2, 5)
    ref = np.asarray(jleg.legendre_series(jnp.asarray(coeffs), jnp.asarray(pts)))
    out = legendre.legendre_series(torch.as_tensor(coeffs), torch.as_tensor(pts)).numpy()
    assert out.shape == (2, 3, 2, 5)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(out[1, 2], np.polynomial.legendre.legval(pts, coeffs[1, 2]), rtol=1e-11, atol=1e-13)
