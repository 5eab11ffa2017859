"""First-order reverse-mode gradients of the port held against ``jax.grad``
(CPU, float64).

Every case of ``tests/test_grad.py``: the same numpy inputs go through
the JAX package under ``jax.grad`` and through the port under
``torch.autograd``, and where the JAX test checks finite differences, the
port is checked against them too.  Added: the batched NT-corrected
intensity gradient on the probe path as well, the gradient with respect
to an isotropic source, the batched flux gradient through
``solve_fluxes`` (the cases of
``tests/test_batch_solve.py::test_batched_grad_matches_vmapped_grad`` and
``tests/test_parallel.py::test_gradients_flow``), NQuad = 48 (the
fused boundary-value Function at 2N = 48, kernel 7's on the card), ties in the
source rescaling, the eigen stage's gradient route, and the boundary-value
Function's backward against native autograd through its plain version.
On CPU tensors the port's kernels run their plain versions inside the
same autograd Functions, so the backward rules themselves are tested.

Both sides run float64 and, under a gradient, the same two-sided Jacobi
(the port's plain version mirrors the JAX package's operation for
operation), so agreement is to roundoff grown by the conditioning of
the solve: rtol 1e-8 unless a case says otherwise.
"""

import dataclasses
from math import pi

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar
from pythonic_disort_tpu.models.disort import eval as jev
from pythonic_disort_tpu.models.disort.api import build_problem as jax_build_problem
from pythonic_disort_tpu.ops import blocktri as jbt
from pythonic_disort_tpu.ops import eig as jeig
from pythonic_disort_tpu.ops import lanes as jlanes

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import batch_solve
from pythonic_disort_torch.models.disort import eval as ev
from pythonic_disort_torch.ops import blocktri, cuda_blocktri, eig
from test_batch_solve import _problem
from test_torch_solve_fluxes import to_port

RTOL = 1e-8
f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def port_grad(loss, *xs):
    """Gradients of the port's scalar ``loss`` at numpy ``xs``, as numpy."""
    leaves = [torch.tensor(np.asarray(x, np.float64), requires_grad=True) for x in xs]
    grads = torch.autograd.grad(loss(*leaves), leaves)
    return [g.numpy() for g in grads]


def jax_grad(loss, *xs):
    g = jax.jit(jax.grad(loss, argnums=tuple(range(len(xs)))))(*(jnp.asarray(x) for x in xs))
    return [np.asarray(x) for x in g]


def fd_grad(loss, x, eps=1e-6):
    """Central finite differences of the port's ``loss`` at numpy ``x``."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    with torch.no_grad():
        for i in range(x.size):
            dx = np.zeros_like(x)
            dx.flat[i] = eps
            g.flat[i] = (float(loss(torch.as_tensor(x + dx))) - float(loss(torch.as_tensor(x - dx)))) / (2 * eps)
    return g


def close(g, ref, rtol=RTOL, label=""):
    np.testing.assert_allclose(g, ref, rtol=rtol, atol=rtol * 1e-3 * np.abs(ref).max(), err_msg=label)


# ------------------------------------------------- single-column path
def _flux_losses(omega_np, *, NFourier=None, only_flux=True, f_g=0.0):
    """loss(omega) through build_problem -> solve -> eval, in both packages."""
    L = len(omega_np)
    tau_np = np.cumsum(np.full(L, 0.7))
    nleg = 8
    leg = np.tile(0.75 ** np.arange(nleg + 1), (L, 1))
    kw = dict(tau_arr=tau_np, omega_arr=omega_np, NQuad=8, Leg_coeffs_all=leg, mu0=0.6, I0=pi,
              phi0=0.4, NFourier=NFourier, only_flux=only_flux, f_arr=(leg[:, nleg] if f_g else 0))
    taus, phis = [0.3, 1.1, tau_np[-1]], [0.0, 2.0]

    def jloss(omega):
        _, prob = jax_build_problem(**kw)
        prob.omega_arr = jnp.asarray(omega, prob.omega_arr.dtype)
        sol = pdt.solve(prob)
        t = jnp.asarray(taus)
        out = jnp.sum(jev.flux_up(sol, t)) + jnp.sum(jev.flux_down(sol, t)[0])
        if not only_flux:
            out = out + jnp.sum(jev.u(sol, t, jnp.asarray(phis)))
        return out

    def loss(omega):
        _, prob = pt.build_problem(**kw, device="cpu")
        prob.omega_arr = omega
        sol = pt.solve(prob)
        t = torch.tensor(taus, dtype=f64)
        out = ev.flux_up(sol, t).sum() + ev.flux_down(sol, t)[0].sum()
        if not only_flux:
            out = out + ev.u(sol, t, torch.tensor(phis, dtype=f64)).sum()
        return out

    return jloss, loss


def test_grad_deltam_multilayer_nfourier():
    """delta-M, 3 layers, NFourier = 8, intensity: d(loss)/d(omega)."""
    omega = np.array([0.55, 0.8, 0.35])
    jloss, loss = _flux_losses(omega, NFourier=8, only_flux=False, f_g=1.0)
    (g,) = port_grad(loss, omega)
    (g_ref,) = jax_grad(jloss, omega)
    close(g, g_ref)
    np.testing.assert_allclose(g, fd_grad(loss, omega), rtol=2e-4, atol=1e-9)


def test_grad_near_conservative():
    """omega = 1 - 1e-6: the smallest K^2 -> 0, where the eigh rule's gap
    formula is stressed; the gradient stays finite and accurate."""
    omega = np.array([1.0 - 1e-6])
    jloss, loss = _flux_losses(omega)
    (g,) = port_grad(loss, omega)
    (g_ref,) = jax_grad(jloss, omega)
    assert np.all(np.isfinite(g))
    # 1 - omega = 1e-6 sets the smallest K^2: roundoff (LAPACK's Cholesky
    # here, the JAX package's own there) grows by about that factor
    close(g, g_ref, rtol=1e-6)
    # the finite-difference step stays inside omega < 1
    np.testing.assert_allclose(g, fd_grad(loss, omega, eps=3e-7), rtol=5e-4)


def test_grad_wrt_beam_geometry():
    """d(flux)/d(mu0) through the particular solution, the boundary rows,
    the direct beam and the device Legendre recurrence at -mu0."""
    kw = dict(tau_arr=np.array([0.5, 1.5]), omega_arr=np.array([0.7, 0.4]), NQuad=8,
              Leg_coeffs_all=np.tile(0.6 ** np.arange(9), (2, 1)), mu0=0.6, I0=pi, phi0=0.0, only_flux=True)
    taus = [0.25, 1.2]

    def jloss(mu0):
        _, prob = jax_build_problem(**kw)
        prob.mu0 = jnp.asarray(mu0, prob.mu0.dtype).reshape(())
        dn, dr = jev.flux_down(pdt.solve(prob), jnp.asarray(taus))
        return jnp.sum(dn) + jnp.sum(dr)

    def loss(mu0):
        _, prob = pt.build_problem(**kw, device="cpu")
        prob.mu0 = mu0.reshape(())
        dn, dr = ev.flux_down(pt.solve(prob), torch.tensor(taus, dtype=f64))
        return dn.sum() + dr.sum()

    (g,) = port_grad(loss, 0.6)
    (g_ref,) = jax_grad(jloss, 0.6)
    close(g, g_ref)
    np.testing.assert_allclose(g, fd_grad(loss, np.array(0.6)), rtol=1e-5)


# ------------------------------------------------- the linear-algebra rules
def test_blocktri_vjp_in_all_operands():
    """The padded block-tridiagonal solve: its transposed-system backward
    against jax.grad and finite differences in every operand."""
    rng = np.random.default_rng(7)
    L, n = 3, 4
    diag = rng.standard_normal((L, n, n)) * 0.2 + np.eye(n) * 3
    lower = rng.standard_normal((L, n, n)) * 0.2
    upper = rng.standard_normal((L, n, n)) * 0.2
    rhs = rng.standard_normal((L, n))
    wgt = rng.standard_normal((L, n))
    ops = (lower, diag, upper, rhs)
    grads = port_grad(lambda *o: (blocktri.solve_block_tridiag(*o) * torch.as_tensor(wgt)).sum(), *ops)
    refs = jax_grad(lambda *o: jnp.sum(jbt.solve_block_tridiag(*o) * wgt), *ops)
    for i, (g, g_ref, base) in enumerate(zip(grads, refs, ops)):
        close(g, g_ref, label=f"operand {i}")

        def loss_i(v, i=i):
            o = [torch.as_tensor(x) for x in ops]
            o[i] = v
            return (blocktri.solve_block_tridiag(*o) * torch.as_tensor(wgt)).sum()

        fd = fd_grad(loss_i, base)
        # lower[0] and upper[L-1] are ignored: the solve does not read them
        if i == 0:
            fd[0] = g[0]
        if i == 2:
            fd[-1] = g[-1]
        np.testing.assert_allclose(g, fd, rtol=5e-6, atol=1e-9)


def test_cholesky_pullback():
    """S -> chol(S S^T + 2I) -> sum(sin(L)): the factor of the eigen
    stage's gradient route (``cholesky_ex``, native backward) against the
    JAX package's ``cholesky_lanes`` and its own rule."""
    S0 = np.random.default_rng(11).standard_normal((2, 5, 5)) * 0.4

    def loss(S):
        return torch.sin(torch.linalg.cholesky_ex(S @ S.mT + 2 * torch.eye(5, dtype=f64))[0]).sum()

    def jloss(S):
        return jnp.sum(jnp.sin(jlanes.cholesky_lanes(jnp.einsum("bij,bkj->bik", S, S) + 2 * jnp.eye(5))))

    (g,) = port_grad(loss, S0)
    (g_ref,) = jax_grad(jloss, S0)
    close(g, g_ref)
    np.testing.assert_allclose(g, fd_grad(loss, S0), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("transpose", [False, True])
def test_triangular_solve_vjp(transpose):
    """L X = B or L^T X = B by ``solve_triangular`` (native backward), as
    the eigen stage's gradient route solves, against the JAX package's
    ``triangular_solve_lanes`` and its own rule."""
    rng = np.random.default_rng(13)
    Lmat = np.tril(rng.standard_normal((4, 4))) + np.eye(4) * 2
    B0 = rng.standard_normal((4, 3))
    tri = np.tri(4)

    def loss(Lm, B):
        Lt = (Lm * torch.as_tensor(tri))[None]
        X = (torch.linalg.solve_triangular(Lt.mT, B[None], upper=True) if transpose
             else torch.linalg.solve_triangular(Lt, B[None], upper=False))
        return torch.cos(X).sum()

    def jloss(Lm, B):
        return jnp.sum(jnp.cos(jlanes.triangular_solve_lanes((Lm * tri)[None], B[None], transpose)))

    grads = port_grad(loss, Lmat, B0)
    refs = jax_grad(jloss, Lmat, B0)
    for g, g_ref in zip(grads, refs):
        close(g, g_ref)
    np.testing.assert_allclose(grads[0], fd_grad(lambda Lm: loss(Lm, torch.as_tensor(B0)), Lmat),
                               rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(grads[1], fd_grad(lambda B: loss(torch.as_tensor(Lmat), B), B0),
                               rtol=1e-6, atol=1e-10)


def test_eigen_stage_gradient_route():
    """Under a gradient the eigen stage is `_eig_stage_ad` (Jacobi); it
    gives the forward-only stage's K and JAX's gradient of a loss that
    does not depend on the eigen column order."""
    rng = np.random.default_rng(5)
    n, B = 4, 6
    from pythonic_disort_torch.ops.quadrature import double_gauss

    mu, w = double_gauss(2 * n)
    ell = np.arange(2 * n)
    coef = (rng.uniform(0.2, 0.99, B)[:, None] / 2) * (2 * ell + 1) * rng.uniform(0, 0.9, B)[:, None] ** ell
    P = np.polynomial.legendre.legvander(mu, 2 * n - 1)
    Dp = np.einsum("il,jl,bl->ijb", P, P, coef)
    Dm = np.einsum("il,jl,bl->ijb", P, P * (-1.0) ** ell, coef)
    t = lambda x: torch.as_tensor(x, dtype=f64)

    # matrix functions X diag(K) X^-1 and Y diag(K^2) Y^-1: free of the
    # order, signs and scaling of the eigen columns
    C1, C2 = rng.standard_normal((2, n, n, B))

    def loss(Dp, Dm):
        K, X, Y, Pm, Q = eig.disort_eigh_lanes(Dp, Dm, t(mu), t(w))
        M1 = torch.einsum("ikb,kb,kjb->ijb", X, K, Pm)
        M2 = torch.einsum("ikb,kb,kjb->ijb", Y, K**2, Q)
        return (M1 * t(C1)).sum() + (M2 * t(C2)).sum() + (K**2).sum()

    def jloss(Dp, Dm):
        K, X, Y, Pm, Q = jeig.disort_eigh_lanes(Dp, Dm, jnp.asarray(mu), jnp.asarray(w))
        M1 = jnp.einsum("ikb,kb,kjb->ijb", X, K, Pm)
        M2 = jnp.einsum("ikb,kb,kjb->ijb", Y, K**2, Q)
        return jnp.sum(M1 * C1) + jnp.sum(M2 * C2) + jnp.sum(K**2)

    K_fwd = eig.disort_eigh_lanes(t(Dp), t(Dm), t(mu), t(w))[0]
    Dp_l = t(Dp).requires_grad_()
    K_ad = eig.disort_eigh_lanes(Dp_l, t(Dm), t(mu), t(w))[0]
    assert K_ad.requires_grad
    np.testing.assert_allclose(np.sort(K_ad.detach().numpy(), 0), np.sort(K_fwd.numpy(), 0), rtol=1e-10)
    grads = port_grad(loss, Dp, Dm)
    refs = jax_grad(jloss, Dp, Dm)
    for g, g_ref in zip(grads, refs):
        close(g, g_ref)


# ------------------------------------------------- the boundary-value Functions
def _bvp_operands(L, N, B, seed):
    rng = np.random.default_rng(seed)
    n2 = 2 * N
    Gt = np.eye(n2)[None, :, :, None] + 0.3 * rng.standard_normal((L, n2, n2, B)) / np.sqrt(n2)
    decay = rng.uniform(0.05, 0.95, (L, N, B))
    bt_rows = np.concatenate([np.eye(N)[:, :, None] + 0.2 * rng.standard_normal((N, N, B)),
                              0.2 * rng.standard_normal((N, N, B))], axis=1)
    return Gt, decay, bt_rows, rng.standard_normal((L, n2, B)), rng.standard_normal((L, n2, B))


@pytest.mark.parametrize("L,N,B", [(1, 2, 3), (3, 4, 5)])
def test_bvp_function_backward_matches_native_autograd(L, N, B):
    """`solve_bvp_fused`'s backward (assemble, transposed solve, pull back)
    against autograd through the operations of its plain version."""
    *ops, r = _bvp_operands(L, N, B, seed=L + N)
    r = torch.as_tensor(r)
    grads = port_grad(lambda *o: (cuda_blocktri.solve_bvp_fused(*o) * r).sum(), *ops)
    refs = port_grad(lambda *o: (cuda_blocktri.solve_bvp_fused_plain(*o) * r).sum(), *ops)
    for i, (g, g_ref) in enumerate(zip(grads, refs)):
        close(g, g_ref, rtol=1e-10, label=f"operand {i}")


@pytest.mark.parametrize("L,N,B", [(1, 4, 2), (4, 2, 7)])
def test_bvp_fused_gradient_matches_assembled_route(L, N, B):
    """The fused route's gradient against the assembled blocks through the
    generic block-Thomas Function (the check chip_smoke.py makes on the
    card on main-path operands)."""
    *ops, r = _bvp_operands(L, N, B, seed=10 + L)
    r = torch.as_tensor(r)
    grads = port_grad(lambda *o: (cuda_blocktri.solve_bvp_fused(*o) * r).sum(), *ops)
    refs = port_grad(lambda G, d, b, rhs: (cuda_blocktri.solve_block_tridiag_lanes_cuda(
        *blocktri.assemble_bvp_blocks(G, d, b), rhs) * r).sum(), *ops)
    for i, (g, g_ref) in enumerate(zip(grads, refs)):
        close(g, g_ref, rtol=1e-10, label=f"operand {i}")


# ------------------------------------------------- batched path
def assert_batched_omega_grad(problem, tau_eval, rtol=RTOL):
    """d sum(flux_up) / d omega through solve_fluxes, port against JAX."""
    tau_j = jnp.asarray(tau_eval)
    g_ref = np.asarray(jax.jit(jax.grad(
        lambda om: jnp.sum(jpar.solve_fluxes(dataclasses.replace(problem, omega_arr=om), tau_j)[0])))(problem.omega_arr))
    port = to_port(problem)
    port.omega_arr = port.omega_arr.clone().requires_grad_()
    pt.solve_fluxes(port, torch.as_tensor(tau_eval))[0].sum().backward()
    g = port.omega_arr.grad.numpy()
    assert np.isfinite(g).all()
    close(g, g_ref, rtol=rtol)


def test_batched_grad_matches_jax():
    """The case of tests/test_batch_solve.py::test_batched_grad_matches_vmapped_grad."""
    problem, tau = _problem(3, 1, True, False, False, True, True, S=2)
    assert_batched_omega_grad(problem, tau)


def test_batched_grad_nquad48():
    """2N = 48 > 32: the fused boundary-value Function carries the gradient
    (kernel 7 forward and kernel 3 on the transposed blocks on the card,
    plain here)."""
    problem, tau = _problem(2, 1, True, False, False, True, True, S=2, nquad=48, seed=3)
    assert_batched_omega_grad(problem, tau)


def test_batched_grad_through_make_batched_problem():
    """The case of tests/test_parallel.py::test_gradients_flow, batched: a
    tensor omega keeps its graph through make_batched_problem."""
    leg = np.array([1, 0, 0.1, 0, 0, 0, 0, 0, 0.0])
    B = 2
    omega0 = np.array([[0.5], [0.6]])
    args = (np.ones((B, 1)), omega0, np.broadcast_to(leg, (B, 1, 9)), np.full(B, 0.8), np.full(B, pi))
    kwargs = dict(nquad=8, nleg=8, nleg_all=9, nfourier=1, nlayers=1, nscoeffs=0, nbdrf=0,
                  has_beam=True, only_flux=True, has_deltam=False)
    tau_eval = np.full((B, 1), 0.3)

    def jloss(om):
        prob = jpar.make_batched_problem(pdt.DisortConfig(**kwargs), args[0], om, *args[2:], dtype=jnp.float64)
        return jnp.sum(jpar.solve_fluxes(prob, jnp.asarray(tau_eval))[0])

    def loss(om):
        prob = pt.make_batched_problem(pt.DisortConfig(**kwargs), args[0], om, *args[2:],
                                       dtype=f64, device="cpu")
        assert prob.omega_arr.requires_grad == om.requires_grad
        return pt.solve_fluxes(prob, torch.as_tensor(tau_eval))[0].sum()

    (g,) = port_grad(loss, omega0)
    (g_ref,) = jax_grad(jloss, omega0)
    close(g, g_ref)
    np.testing.assert_allclose(g, fd_grad(loss, omega0), rtol=1e-4)


def test_batched_grad_rescale_ties():
    """I0 and every entry of b_pos equal: the source rescaling's maxima tie
    and split their gradient evenly, as jnp.max does."""
    problem, tau = _problem(2, 2, True, False, False, True, True, S=2, seed=4)
    N, NF = 4, 2
    b_pos = np.full((2, N, NF), pi)
    b_neg = np.zeros((2, N, NF))
    I0 = np.full(2, pi)
    tau_j = jnp.asarray(tau)

    def jloss(I0, b_pos, b_neg):
        p = dataclasses.replace(problem, I0=I0, b_pos=b_pos, b_neg=b_neg)
        fup, fdn, fdir = jpar.solve_fluxes(p, tau_j)
        return jnp.sum(fup) + jnp.sum(fdn * fdir)

    port = to_port(problem)

    def loss(I0, b_pos, b_neg):
        p = dataclasses.replace(port, I0=I0, b_pos=b_pos, b_neg=b_neg)
        fup, fdn, fdir = pt.solve_fluxes(p, torch.as_tensor(tau))
        return fup.sum() + (fdn * fdir).sum()

    grads = port_grad(loss, I0, b_pos, b_neg)
    refs = jax_grad(jloss, I0, b_pos, b_neg)
    for g, g_ref in zip(grads, refs):
        close(g, g_ref)


def test_batched_grad_wrt_every_leaf():
    """BDRF surface, two Fourier modes, delta-M: gradients with respect to
    tau, f, the Legendre moments and the BDRF modes (the in-place writes
    into fresh zeros of the BDRF operators included)."""
    problem, tau = _problem(3, 2, True, False, True, True, True, S=2, seed=6)
    names = ("tau_arr", "f_arr", "leg_coeffs_all", "bdrf_modes", "bdrf_modes_mu0")
    tau_eval = tau * 0.6
    tau_j = jnp.asarray(tau_eval)

    def jloss(*leaves):
        fup, fdn, _ = jpar.solve_fluxes(dataclasses.replace(problem, **dict(zip(names, leaves))), tau_j)
        return jnp.sum(fup) + jnp.sum(fdn**2)

    port = to_port(problem)

    def loss(*leaves):
        fup, fdn, _ = pt.solve_fluxes(dataclasses.replace(port, **dict(zip(names, leaves))),
                                      torch.as_tensor(tau_eval))
        return fup.sum() + (fdn**2).sum()

    leaves = [np.asarray(getattr(problem, k)) for k in names]
    for name, g, g_ref in zip(names, port_grad(loss, *leaves), jax_grad(jloss, *leaves)):
        close(g, g_ref, label=name)


@pytest.mark.parametrize("probes_per_layer", [False, True])
def test_grad_through_batched_nt_corrected_intensity(probes_per_layer):
    """The case of tests/test_grad.py::test_grad_through_batched_nt_corrected_intensity:
    d sum(u^2) / d omega through ``solve_intensity`` with the NT correction,
    the problem built inside the loss; on the general path at the JAX
    test's probes, and on the probe path at one probe per layer."""
    B, L, nquad, nleg, nleg_all = 2, 3, 8, 8, 24
    rng = np.random.default_rng(3)
    tau = np.cumsum(rng.uniform(0.3, 1.0, (B, L)), axis=1)
    g = rng.uniform(0.6, 0.75, (B, L))
    leg = g[..., None] ** np.arange(nleg_all)[None, None, :]
    f_arr = leg[..., nleg]
    mu0 = rng.uniform(0.5, 1.0, B)
    kwargs = dict(nquad=nquad, nleg=nleg, nleg_all=nleg_all, nfourier=nquad, nlayers=L, nscoeffs=0, nbdrf=0,
                  has_beam=True, only_flux=False, has_deltam=True, nt_correct=True)
    tau_eval = tau * (1 - 1e-9) if probes_per_layer else tau * 0.7
    phi_eval = np.broadcast_to(np.array([0.4, 2.2]), (B, 2)).copy()
    omega0 = rng.uniform(0.6, 0.9, (B, L))

    def jloss(omega):
        prob = jpar.make_batched_problem(pdt.DisortConfig(**kwargs), tau, omega, leg, mu0, np.full(B, pi),
                                         f_arr=f_arr, dtype=jnp.float64)
        u = jpar.solve_intensity(prob, jnp.asarray(tau_eval), jnp.asarray(phi_eval),
                                 probes_per_layer=probes_per_layer)
        return jnp.sum(u**2)

    def loss(omega):
        prob = pt.make_batched_problem(pt.DisortConfig(**kwargs), tau, omega, leg, mu0, np.full(B, pi),
                                       f_arr=f_arr, dtype=f64, device="cpu")
        u = pt.solve_intensity(prob, tau_eval, phi_eval, probes_per_layer=probes_per_layer)
        return (u**2).sum()

    (g,) = port_grad(loss, omega0)
    (g_ref,) = jax_grad(jloss, omega0)
    assert np.isfinite(g).all()
    close(g, g_ref)


def test_batched_grad_wrt_iso_source():
    """An isotropic source with beam, BDRF and delta-M (a row of
    tests/test_batch_solve.py::CASES): d (sum(fup) + sum(fdn)) with respect
    to the source polynomials and omega through ``solve_fluxes``."""
    problem, tau = _problem(4, 1, True, True, True, True, True, S=2, seed=8)
    names = ("s_poly_coeffs", "omega_arr")
    tau_eval = tau * 0.6
    tau_j = jnp.asarray(tau_eval)

    def jloss(*leaves):
        fup, fdn, _ = jpar.solve_fluxes(dataclasses.replace(problem, **dict(zip(names, leaves))), tau_j)
        return jnp.sum(fup) + jnp.sum(fdn)

    port = to_port(problem)

    def loss(*leaves):
        fup, fdn, _ = pt.solve_fluxes(dataclasses.replace(port, **dict(zip(names, leaves))),
                                      torch.as_tensor(tau_eval))
        return fup.sum() + fdn.sum()

    leaves = [np.asarray(getattr(problem, k)) for k in names]
    for name, g, g_ref in zip(names, port_grad(loss, *leaves), jax_grad(jloss, *leaves)):
        assert np.abs(g).max() > 0, name
        close(g, g_ref, label=name)


def test_config_tables_never_require_grad():
    problem, tau = _problem(3, 1, True, False, False, True, True, S=2)
    port = to_port(problem)
    port.omega_arr = port.omega_arr.clone().requires_grad_()
    pt.solve_fluxes(port, torch.as_tensor(tau))[0].sum().backward()
    cfg = port.config
    tab = batch_solve._tables(cfg.nquad, cfg.nleg, cfg.nleg_all, cfg.nfourier, f64, torch.device("cpu"))
    assert not any(x.requires_grad for x in tab)
