"""Forward-mode derivatives of the port's eigen stage held against ``jax.jvp``
(CPU, float64).

``torch.autograd.forward_ad`` through ``ops.jacobi.jacobi_eigh`` (its ``jvp``
is the symmetric-eigendecomposition rule of the JAX package's
``_eigh_jvp_rule``) and through ``ops.eig.disort_eigh_lanes``, whose dual
operands take ``_eig_stage_ad``: a forward-mode tangent does not set
``requires_grad``, so the route is chosen by the tangent itself, and the
kernel entries refuse an operand that carries one.  Forward mode through
the whole solve raises in both packages: their block-tridiagonal solves
carry reverse-mode rules only.

The JAX package refuses odd n, so n = 5 is held against ``jax.jvp`` of
``jnp.linalg.eigh``, with the eigenvector signs matched.
"""

from math import pi

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar
from pythonic_disort_tpu.ops import eig as jeig
from pythonic_disort_tpu.ops import jacobi as jjacobi

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort.solve import _tables
from pythonic_disort_torch.ops import _build, eig
from pythonic_disort_torch.ops.jacobi import jacobi_eigh

RTOL = 1e-10
f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _sym(rng, shape):
    a = rng.standard_normal(shape)
    return a + np.swapaxes(a, -1, -2)


def port_jvp(fn, primals, tangents):
    """``(outputs, output tangents)`` of the port's ``fn`` under forward AD, as numpy."""
    with fwAD.dual_level():
        outs = fn(*(fwAD.make_dual(torch.tensor(p), torch.tensor(t)) for p, t in zip(primals, tangents)))
        pairs = [fwAD.unpack_dual(o) for o in outs]
        return [p.primal.numpy() for p in pairs], [p.tangent.numpy() for p in pairs]


def close(x, ref, rtol=RTOL, label=""):
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=label)


# ----------------------------------------------------------------- jacobi_eigh
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [4, 6])
def test_jacobi_jvp_matches_jax(n, sort):
    """Even n: the same sweeps in both packages give the same eigenpairs in
    the same order and signs, sorted or not, so w, V and their tangents are
    compared directly."""
    rng = np.random.default_rng(n)
    A, dA = _sym(rng, (3, n, n)), _sym(rng, (3, n, n))
    (w, V), (dw, dV) = port_jvp(lambda a: jacobi_eigh(a, sort=sort), (A,), (dA,))
    (w_ref, V_ref), (dw_ref, dV_ref) = jax.jvp(lambda a: jjacobi.jacobi_eigh(a, sort=sort),
                                               (jnp.asarray(A),), (jnp.asarray(dA),))
    for label, x, ref in (("w", w, w_ref), ("V", V, V_ref), ("dw", dw, dw_ref), ("dV", dV, dV_ref)):
        close(x, np.asarray(ref), label=label)


@pytest.mark.parametrize("sort", [True, False])
def test_jacobi_jvp_odd_n_matches_lapack_rule(sort):
    """n = 5, which the JAX package refuses: against ``jax.jvp`` of
    ``jnp.linalg.eigh``, the port's columns put in ascending order (unsorted)
    and their signs matched to LAPACK's."""
    rng = np.random.default_rng(5)
    A, dA = _sym(rng, (3, 5, 5)), _sym(rng, (3, 5, 5))
    (w, V), (dw, dV) = port_jvp(lambda a: jacobi_eigh(a, sort=sort), (A,), (dA,))
    (w_ref, V_ref), (dw_ref, dV_ref) = jax.jvp(jnp.linalg.eigh, (jnp.asarray(A),), (jnp.asarray(dA),))
    order = np.argsort(w, axis=-1)
    take = lambda x: np.take_along_axis(x, order[:, None, :], axis=-1)
    w, dw = np.take_along_axis(w, order, -1), np.take_along_axis(dw, order, -1)
    sign = np.sign(np.einsum("bij,bij->bj", take(V), np.asarray(V_ref)))[:, None, :]
    close(w, np.asarray(w_ref), label="w")
    close(dw, np.asarray(dw_ref), label="dw")
    close(sign * take(V), np.asarray(V_ref), label="V")
    close(sign * take(dV), np.asarray(dV_ref), rtol=1e-9, label="dV")


def test_jacobi_jvp_near_degenerate():
    """The near-degenerate matrix of ``tests/test_grad.py:96``: the tangent of
    sum(w^2) along a symmetric direction stays finite and matches ``jax.jvp``
    and central differences."""
    rng = np.random.default_rng(3)
    Qm, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    lam = np.array([0.5, 1.0, 1.0 + 1e-9, 2.0, 3.0, 4.0])
    A0 = (Qm * lam) @ Qm.T
    Sd = rng.standard_normal((6, 6)) * 0.1
    direction = Sd + Sd.T

    def loss(t):
        return (jacobi_eigh(torch.tensor(A0)[None] + t * torch.tensor(direction)[None])[0] ** 2).sum()

    def jloss(t):
        return jnp.sum(jjacobi.jacobi_eigh((jnp.asarray(A0) + t * jnp.asarray(direction))[None])[0] ** 2)

    with fwAD.dual_level():
        d = fwAD.unpack_dual(loss(fwAD.make_dual(torch.tensor(0.0, dtype=f64), torch.tensor(1.0, dtype=f64))))
        value, tangent = float(d.primal), float(d.tangent)
    _, ref = jax.jvp(jloss, (jnp.asarray(0.0),), (jnp.asarray(1.0),))
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(eps)) - float(loss(-eps))) / (2 * eps)
    assert np.isfinite(tangent) and np.isclose(value, np.sum(lam**2), rtol=1e-12)
    np.testing.assert_allclose(tangent, float(ref), rtol=1e-10)
    np.testing.assert_allclose(tangent, fd, rtol=1e-6)


def test_jacobi_jvp_is_the_transpose_of_its_backward():
    """<v, J u> from forward mode equals <J^T v, u> from reverse mode."""
    rng = np.random.default_rng(11)
    A, dA = _sym(rng, (2, 6, 6)), _sym(rng, (2, 6, 6))
    cw, cV = rng.standard_normal((2, 6)), rng.standard_normal((2, 6, 6))
    _, (dw, dV) = port_jvp(jacobi_eigh, (A,), (dA,))
    At = torch.tensor(A, requires_grad=True)
    w, V = jacobi_eigh(At)
    (gA,) = torch.autograd.grad((w * torch.tensor(cw)).sum() + (V * torch.tensor(cV)).sum(), At)
    np.testing.assert_allclose(np.sum(cw * dw) + np.sum(cV * dV), np.sum(gA.numpy() * dA), rtol=1e-10)


# ------------------------------------------------------------- the eigen stage
def _kernels(B, N=4, seed=0):
    """Mode-0 scattering kernels D+, D- (N, N, B) of B random layers, the
    ``(omega / 2) (2l + 1) g_l`` contraction of ``batch_solve._solve``,
    with symmetric tangents; and the quadrature ``mu``, ``w``."""
    rng = np.random.default_rng(seed)
    nleg = 2 * N
    tab = _tables(2 * N, nleg, nleg + 1, 1, f64, torch.device("cpu"))
    lam, parity = tab.lam_mu[0].numpy(), tab.parity[0].numpy()                   # (nleg, N), (nleg,)
    g, omega = rng.uniform(0.3, 0.8, B), rng.uniform(0.3, 0.95, B)
    c = (omega / 2)[None] * (2 * np.arange(nleg) + 1)[:, None] * g[None] ** np.arange(nleg)[:, None]
    Dp = np.einsum("li,lj,lb->ijb", lam, lam, c)
    Dm = np.einsum("li,lj,lb->ijb", lam, lam, parity[:, None] * c)
    dDp, dDm = (0.05 * _sym(rng, (B, N, N)).transpose(1, 2, 0) for _ in range(2))
    return (Dp, Dm), (dDp, dDm), tab.mu.numpy(), tab.w.numpy()


def _by_k(K, X, P, dK, dX, dP):
    """K, its tangent, the spectral projectors X[:, i] P[i, :] and their
    tangents, in ascending K per lane: free of the eigen columns' order
    and gauge.  K (N, B), X and P (N, N, B)."""
    order = np.argsort(K, axis=0)
    K, dK = np.take_along_axis(K, order, 0), np.take_along_axis(dK, order, 0)
    proj = np.einsum("ikb,kjb->kijb", X, P)
    dproj = np.einsum("ikb,kjb->kijb", dX, P) + np.einsum("ikb,kjb->kijb", X, dP)
    pick = lambda x: np.take_along_axis(x, order[:, None, None, :], 0)
    return K, dK, pick(proj), pick(dproj)


@pytest.mark.parametrize("N", [4, 8])
def test_disort_eigh_lanes_jvp_matches_jax(N):
    """Tangents of K and of the projectors against ``jax.jvp`` of the JAX
    package's ``disort_eigh_lanes``, whose tangent goes through its own
    ``_eig_stage_ad``."""
    (Dp, Dm), (dDp, dDm), mu, w = _kernels(6, N=N)
    (K, X, _, P, _), (dK, dX, _, dP, _) = port_jvp(
        lambda a, b: eig.disort_eigh_lanes(a, b, torch.tensor(mu), torch.tensor(w)), (Dp, Dm), (dDp, dDm))
    ref, dref = jax.jvp(lambda a, b: jeig.disort_eigh_lanes(a, b, jnp.asarray(mu), jnp.asarray(w)),
                        (jnp.asarray(Dp), jnp.asarray(Dm)), (jnp.asarray(dDp), jnp.asarray(dDm)))
    ref, dref = [np.asarray(x) for x in ref], [np.asarray(x) for x in dref]
    got = _by_k(K, X, P, dK, dX, dP)
    want = _by_k(ref[0], ref[1], ref[3], dref[0], dref[1], dref[3])
    for label, x, r in zip(("K", "dK", "projectors", "d projectors"), got, want):
        close(x, r, rtol=1e-9, label=label)


def test_dual_operands_take_eig_stage_ad(monkeypatch):
    """Operands with a forward-mode tangent take ``_eig_stage_ad``; the same
    operands without one take the fused stage (kernel 1 on the card)."""
    calls = {"ad": 0, "fused": 0}
    ad, fused = eig._eig_stage_ad, eig.eig_stage_lanes

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(eig, "_eig_stage_ad", counted("ad", ad))
    monkeypatch.setattr(eig, "eig_stage_lanes", counted("fused", fused))
    (Dp, Dm), (dDp, dDm), mu, w = _kernels(3)
    args = (torch.tensor(mu), torch.tensor(w))
    with torch.no_grad():
        eig.disort_eigh_lanes(torch.tensor(Dp), torch.tensor(Dm), *args)
    assert calls == {"ad": 0, "fused": 1}
    with fwAD.dual_level():
        K = eig.disort_eigh_lanes(fwAD.make_dual(torch.tensor(Dp), torch.tensor(dDp)), torch.tensor(Dm), *args)[0]
        assert fwAD.unpack_dual(K).tangent is not None
    assert calls == {"ad": 1, "fused": 1}
    with fwAD.dual_level(), torch.no_grad():
        eig.disort_eigh_lanes(torch.tensor(Dp), fwAD.make_dual(torch.tensor(Dm), torch.tensor(dDm)), *args)
    assert calls == {"ad": 2, "fused": 1}


def test_refuse_tangents():
    """The kernel entries' check: an operand with a tangent raises; one
    without, or one that only requires a gradient, passes."""
    x = torch.ones(3, dtype=f64)
    _build.refuse_tangents("entry", (x, x.clone().requires_grad_()), "route")
    assert not _build.has_tangent(x)
    with fwAD.dual_level():
        dual = fwAD.make_dual(x, torch.ones_like(x))
        assert _build.has_tangent(dual) and not dual.requires_grad
        with pytest.raises(NotImplementedError, match="entry: the kernel carries no forward-mode tangent; route"):
            _build.refuse_tangents("entry", (x, dual), "route")


# ----------------------------------------------------------------- the solve
def test_solve_fluxes_with_dual_omega_raises():
    """Forward mode through the whole batched solve raises, in the port at
    the boundary-value Function and in the JAX package at its custom VJPs."""
    rng = np.random.default_rng(2)
    S, L = 2, 2
    tau = np.cumsum(rng.uniform(0.2, 0.8, (S, L)), axis=1)
    omega = rng.uniform(0.3, 0.9, (S, L))
    leg = rng.uniform(0.3, 0.7, (S, L, 1)) ** np.arange(9)
    mu0, I0 = rng.uniform(0.4, 0.9, S), np.full(S, pi)
    cfg = dict(nquad=8, nleg=8, nleg_all=9, nfourier=1, nlayers=L, nscoeffs=0, nbdrf=0, has_beam=True,
               only_flux=True, has_deltam=False)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(omega), torch.ones(S, L, dtype=f64))
        problem = pt.make_batched_problem(pt.DisortConfig(**cfg), tau, dual, leg, mu0, I0, dtype=f64, device="cpu")
        with pytest.raises(NotImplementedError, match="jvp"):
            pt.solve_fluxes(problem, torch.tensor(tau))

    def jfluxes(om):
        problem = jpar.make_batched_problem(pdt.DisortConfig(**cfg), tau, om, leg, mu0, I0, dtype=jnp.float64)
        return jpar.solve_fluxes(problem, jnp.asarray(tau))[0]

    with pytest.raises(TypeError, match="custom_vjp"):
        jax.jvp(jfluxes, (jnp.asarray(omega),), (jnp.ones((S, L)),))
