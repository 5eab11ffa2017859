"""Batched gradients with respect to the beam's mu0, held against ``jax.grad``
(CPU, float64).

The batched counterpart of ``tests/test_grad.py::test_grad_wrt_beam_geometry``.
A mu0 that requires a gradient is kept by ``make_batched_problem`` as the
problem's own leaf, with no host table ``lam_mu0``: the solve builds the
beam's Legendre table at -mu0 on the device, so d lam(-mu0) / d mu0 stays in
the graph.  The JAX problem is built inside the differentiated function, so
that its mu0 is a tracer and the JAX package takes its own device recurrence
(``lam_mu0=None``).  The same numpy inputs, made from a seed, go through
both; agreement is to roundoff grown by the conditioning of the solve.
"""

from math import pi

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar

import pythonic_disort_torch as pt

RTOL = 1e-8
f64 = torch.float64
S, NQUAD, PHI = 4, 8, (0.3, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(nlayers, nfourier, deltam, iso=False, bdrf=False, only_flux=True, nt=False, seed=0):
    """Config and numpy inputs of a batch of S beam problems at NQuad = 8."""
    rng = np.random.default_rng(seed)
    N, nleg_all = NQUAD // 2, (3 * NQUAD if nt else NQUAD + 1)
    tau = np.cumsum(rng.uniform(0.2, 0.8, (S, nlayers)), axis=1)
    g = rng.uniform(0.3, 0.8, (S, nlayers))
    leg = g[..., None] ** np.arange(nleg_all)[None, None, :]
    kw = dict(
        tau=tau, omega=rng.uniform(0.3, 0.9, (S, nlayers)), leg=leg, mu0=rng.uniform(0.35, 0.95, S),
        I0=np.full(S, pi), phi0=rng.uniform(0.0, 2 * pi, S), f_arr=leg[..., NQUAD] if deltam else None,
        s_poly=rng.uniform(0.1, 1.0, (S, nlayers, 2)) if iso else None,
        bdrf_modes=np.broadcast_to(rng.uniform(0.1, 0.3, (S, 1, 1, 1)), (S, 1, N, N)).copy() if bdrf else None,
        tau_eval=tau * 0.8,
    )
    kw["bdrf_mu0"] = kw["bdrf_modes"][:, :, 0, :].copy() if bdrf else None
    cfg = dict(nquad=NQUAD, nleg=NQUAD, nleg_all=nleg_all, nfourier=nfourier, nlayers=nlayers,
               nscoeffs=2 if iso else 0, nbdrf=1 if bdrf else 0, has_beam=True, only_flux=only_flux,
               has_deltam=deltam, nt_correct=nt)
    return cfg, kw


def _problem(mod, cfg, kw, mu0, dtype, **device):
    config = (pdt if mod is jpar else pt).DisortConfig(**cfg)
    return mod.make_batched_problem(
        config, kw["tau"], kw["omega"], kw["leg"], mu0, kw["I0"], phi0=kw["phi0"],
        f_arr=kw["f_arr"], s_poly_coeffs=kw["s_poly"], bdrf_modes=kw["bdrf_modes"],
        bdrf_modes_mu0=kw["bdrf_mu0"], dtype=dtype, **device)


def _outputs(mod, output, problem, tau, phi):
    """The solve's outputs of one entry point, as a tuple."""
    if output == "fluxes":
        return mod.solve_fluxes(problem, tau)
    if output == "actinic":
        return mod.solve_actinic(problem, tau)
    return (mod.solve_intensity(problem, tau, phi, probes_per_layer=output == "probes"),)


def _losses(cfg, kw, output):
    """loss(mu0) through make_batched_problem and the entry point, in both
    packages: a weighted sum of every output."""
    rng = np.random.default_rng(1)
    phi = np.tile(PHI, (S, 1))
    tau_eval = kw["tau"] if output == "probes" else kw["tau_eval"]
    weights = None

    def jloss(mu0):
        problem = _problem(jpar, cfg, kw, mu0, jnp.float64)
        outs = _outputs(jpar, output, problem, jnp.asarray(tau_eval), jnp.asarray(phi))
        return sum(jnp.sum(jnp.asarray(w) * o) for w, o in zip(weights, outs))

    def loss(mu0):
        problem = _problem(pt, cfg, kw, mu0, f64, device="cpu")
        outs = _outputs(pt, output, problem, torch.as_tensor(tau_eval), torch.as_tensor(phi))
        return sum((torch.as_tensor(w) * o).sum() for w, o in zip(weights, outs))

    with torch.no_grad():
        shapes = [o.shape for o in _outputs(pt, output, _problem(pt, cfg, kw, kw["mu0"], f64, device="cpu"),
                                            torch.as_tensor(tau_eval), torch.as_tensor(phi))]
    weights = [rng.uniform(0.5, 1.5, s) for s in shapes]
    return jloss, loss


CASES = {
    # name: (_inputs kwargs, output)
    "fluxes, delta-M, L=3": (dict(nlayers=3, nfourier=1, deltam=True), "fluxes"),
    "fluxes, no delta-M, L=2": (dict(nlayers=2, nfourier=1, deltam=False), "fluxes"),
    "fluxes, iso source and BDRF, L=2": (dict(nlayers=2, nfourier=1, deltam=True, iso=True, bdrf=True), "fluxes"),
    "actinic, L=2": (dict(nlayers=2, nfourier=1, deltam=True, only_flux=False), "actinic"),
    "u, NFourier=3, L=2": (dict(nlayers=2, nfourier=3, deltam=True, only_flux=False), "u"),
    "u, NFourier=3, NT-corrected, L=2": (dict(nlayers=2, nfourier=3, deltam=True, only_flux=False, nt=True), "u"),
    "u, NFourier=3, probes per layer, L=3": (dict(nlayers=3, nfourier=3, deltam=True, only_flux=False), "probes"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_batched_mu0_gradient_matches_jax(name):
    inputs, output = CASES[name]
    cfg, kw = _inputs(**inputs)
    jloss, loss = _losses(cfg, kw, output)
    g_ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(kw["mu0"])))
    mu0 = torch.tensor(kw["mu0"], dtype=f64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(mu0), mu0)
    assert np.abs(g_ref).min() > 0
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=RTOL, atol=RTOL * 1e-3 * np.abs(g_ref).max(), err_msg=name)


def test_batched_mu0_gradient_matches_finite_differences():
    """d loss / d mu0 against central differences of the port itself."""
    cfg, kw = _inputs(nlayers=3, nfourier=1, deltam=True)
    _, loss = _losses(cfg, kw, "fluxes")
    mu0 = torch.tensor(kw["mu0"], dtype=f64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(mu0), mu0)
    eps, fd = 1e-6, np.zeros(S)
    with torch.no_grad():
        for i in range(S):
            d = torch.zeros(S, dtype=f64)
            d[i] = eps
            fd[i] = (float(loss(mu0 + d)) - float(loss(mu0 - d))) / (2 * eps)
    np.testing.assert_allclose(g.numpy(), fd, rtol=1e-6)


@pytest.mark.parametrize("nfourier", [1, 3])
def test_device_table_equals_host_table(nfourier):
    """A mu0 that requires a gradient leaves ``lam_mu0`` None and the solve
    builds the table on the device; a mu0 without one keeps the host table.
    The two routes give the same solution."""
    cfg, kw = _inputs(nlayers=2, nfourier=nfourier, deltam=True, only_flux=False)
    host = _problem(pt, cfg, kw, torch.tensor(kw["mu0"], dtype=f64), f64, device="cpu")
    leaf = torch.tensor(kw["mu0"], dtype=f64, requires_grad=True)
    dev = _problem(pt, cfg, kw, leaf, f64, device="cpu")
    assert host.lam_mu0 is not None and host.lam_mu0.shape == (S, nfourier, NQUAD)
    assert dev.lam_mu0 is None and dev.mu0 is leaf
    phi = torch.as_tensor(np.tile(PHI, (S, 1)))
    tau = torch.as_tensor(kw["tau_eval"])
    with torch.no_grad():
        for a, b in zip(_outputs(pt, "fluxes", host, tau, phi) + _outputs(pt, "u", host, tau, phi),
                        _outputs(pt, "fluxes", dev, tau, phi) + _outputs(pt, "u", dev, tau, phi)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-15)
