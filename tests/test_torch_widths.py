"""Every NQuad the port validates, held on the CPU in float64: odd
N = NQuad/2 (two-stream NQuad = 2, and 6, 10, ...) and N > 32.

At those widths the eigen stage takes the route of the JAX package's
``_eig_stage_lanes_jnp`` (Cholesky, congruence, two-sided Jacobi,
triangular solve; ``ops.eig._eig_stage_ad``) on either device, with the
round-robin schedule extended to odd n; on the card its Jacobi is kernel 5
and block sizes 2N > 64 go to kernel 6, whose plain versions run here.

- NQuad = 68 against the JAX package: ``pydisort`` with the NT
  corrections, the batched ``solve_fluxes`` and a gradient.
- Odd N, which the JAX package refuses (its schedule asserts even n):
  ``pydisort`` against the same call with the eigen stage swapped for
  LAPACK's ``eigh`` (``test_torch_eig_f32.lapack_stage``), two independent
  eigensolvers; the plain Jacobi at odd n against ``torch.linalg.eigh``.

Inputs are made with numpy from a seed.
"""

import warnings
from math import pi

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu.models.disort.api import build_problem as jax_build_problem
from pythonic_disort_tpu.models.disort import eval as jev
from pythonic_disort_tpu.ops import jacobi as jjac
from pythonic_disort_tpu.parallel import solve_fluxes as jax_solve_fluxes

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import eval as ev
from pythonic_disort_torch.ops import cuda_blocktri, cuda_jacobi, eig, jacobi
from pythonic_disort_torch.ops.quadrature import double_gauss
from test_batch_solve import _problem
from test_torch_eig_f32 import lapack_stage
from test_torch_solve_fluxes import to_port

f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------- the schedule
@pytest.mark.parametrize("n", range(1, 66))
def test_round_robin_schedule(n):
    """Each unordered pair once per sweep, the pairs of a round disjoint;
    even n: the JAX package's schedule exactly."""
    p, q = jacobi._round_robin_schedule(n)
    rounds = n - 1 if n % 2 == 0 else (n if n > 1 else 0)
    assert p.shape == q.shape == (rounds, n // 2 if n > 1 else 0)
    assert (p < q).all()
    for pr, qr in zip(p, q):
        assert len(set(pr) | set(qr)) == 2 * len(pr)
    pairs = sorted(zip(p.ravel().tolist(), q.ravel().tolist()))
    assert pairs == [(i, j) for i in range(n) for j in range(i + 1, n)]
    if n % 2 == 0:
        jp, jq = jjac._round_robin_schedule(n)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(q, jq)


# --------------------------------------------- the plain Jacobi at odd n
def congruence_operands(n, B, seed):
    """M = L^T (-At) L, L = chol(-Bt), (B, n, n): the eigen stage's Jacobi
    operand for one Fourier mode of random Henyey-Greenstein layers at
    NQuad = 2n."""
    rng = np.random.default_rng(seed)
    mu, w = double_gauss(2 * n)
    ell = np.arange(2 * n)
    coef = (rng.uniform(0.2, 0.99, B)[:, None] / 2) * (2 * ell + 1) * rng.uniform(0.0, 0.9, B)[:, None] ** ell
    P = np.polynomial.legendre.legvander(mu, 2 * n - 1)
    Dp = np.einsum("il,jl,bl->bij", P, P, coef)
    Dm = np.einsum("il,jl,bl->bij", P, P * (-1.0) ** ell, coef)
    rho = np.sqrt(w / mu)
    At = rho[:, None] * (Dp - Dm) * rho[None, :] - np.diag(1 / mu)
    Bt = rho[:, None] * (Dp + Dm) * rho[None, :] - np.diag(1 / mu)
    Lc = np.linalg.cholesky(-Bt)
    return np.swapaxes(Lc, 1, 2) @ (-At) @ Lc


def random_symmetric(n, B, seed):
    S = np.random.default_rng(seed).standard_normal((B, n, n))
    return S + np.swapaxes(S, 1, 2)


@pytest.mark.parametrize("n", [1, 3, 17, 33])
@pytest.mark.parametrize("kind", ["random", "congruence"])
def test_plain_jacobi_odd_n(n, kind):
    """Sorted w against LAPACK's, |V^T V - I| and |V diag(w) V^T - A|, each
    within 1e-10 of max |A| (float64 roundoff grown by n and the sweeps)."""
    A = (random_symmetric if kind == "random" else congruence_operands)(n, 5, seed=n)
    At = torch.as_tensor(np.ascontiguousarray(np.moveaxis(A, 0, -1)))
    w, V = jacobi.jacobi_eigh_lanes_raw(At)
    w, V = w.T.numpy(), V.permute(2, 0, 1).numpy()
    scale = np.abs(A).max()
    ref = torch.linalg.eigh(torch.as_tensor(A))[0].numpy()
    assert np.abs(np.sort(w, axis=1) - ref).max() < 1e-10 * scale
    assert np.abs(np.swapaxes(V, 1, 2) @ V - np.eye(n)).max() < 1e-10
    assert np.abs(np.einsum("bij,bj,bkj->bik", V, w, V) - A).max() < 1e-10 * scale


# ----------------------------------------------------------- the route
@pytest.mark.parametrize("N,route", [(1, "ad"), (3, "ad"), (33, "ad"), (34, "ad"), (2, "kernel1"),
                                     (16, "kernel1"), (32, "kernel1")])
def test_eigen_stage_route(N, route, monkeypatch):
    """Odd N and N > 32 take the Cholesky + Jacobi route on the CPU as on
    the card; even N <= 32 take kernel 1's (its plain version here)."""
    taken = []
    for name in ("_eig_stage_ad", "eig_stage_lanes"):
        fn = getattr(eig, name)
        monkeypatch.setattr(eig, name, lambda *a, fn=fn, name=name: taken.append(name) or fn(*a))
    mu, w = (torch.as_tensor(x) for x in double_gauss(2 * N))
    D = torch.as_tensor(np.moveaxis(random_symmetric(N, 3, seed=N), 0, -1) * 0.01).contiguous()
    K, X, Y, P, Q = eig.disort_eigh_lanes(D, 0.5 * D, mu, w)
    assert taken == ["_eig_stage_ad" if route == "ad" else "eig_stage_lanes"]
    assert torch.isfinite(K).all() and K.shape == (N, 3)
    eye = torch.eye(N, dtype=f64)[:, :, None]
    assert (torch.einsum("ijb,jkb->ikb", P, X) - eye).abs().max() < 1e-10


# -------------------------------------------- odd N against LAPACK's eigh
@pytest.mark.parametrize("nquad", [2, 6, 10])
def test_pydisort_odd_n_matches_lapack_route(nquad, monkeypatch):
    """Fluxes, u0 and u of the Jacobi route against the same call with the
    eigen stage on LAPACK's eigh, rtol 1e-11 (two float64 eigensolvers
    on well-separated spectra)."""
    L = 3
    leg = np.tile(0.7 ** np.arange(nquad + 1), (L, 1))
    kw = dict(tau_arr=np.array([0.4, 1.1, 2.5]), omega_arr=np.array([0.9, 0.6, 0.8]), NQuad=nquad,
              Leg_coeffs_all=leg, mu0=0.62, I0=pi, phi0=0.7, f_arr=leg[:, nquad], NT_cor=True,
              b_neg=0.1)
    tau, phi = np.linspace(0.0, 2.5, 6), np.array([0.0, 1.3])

    def run():
        _, fu, fd, u0, u = pt.pydisort(**kw, device="cpu")
        return [fu(tau), *fd(tau), u0(tau), u(tau, phi)]

    out = run()
    monkeypatch.setattr(eig, "_eig_stage", lapack_stage)
    ref = run()
    for lbl, a, b in zip(("flux_up", "flux_down diffuse", "flux_down direct", "u0", "u"), ref, out):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-13 * np.abs(a).max(), err_msg=lbl)


# -------------------------------------------- NQuad = 68 against the JAX package
NQ = 68


def column_kwargs(L=3):
    leg = np.tile(0.75 ** np.arange(NQ + 1), (L, 1))
    return dict(tau_arr=np.array([0.5, 1.5, 3.0])[:L], omega_arr=np.array([0.9, 0.85, 0.8])[:L], NQuad=NQ,
                Leg_coeffs_all=leg, mu0=0.6, I0=pi, phi0=pi / 2, f_arr=leg[:, NQ])


def test_pydisort_nquad68_matches_jax():
    """3 layers, beam, delta-M, the NT corrections, 68 Fourier modes: block
    size 2N = 68 takes kernel 6 on the card and N = 34 the Jacobi route;
    fluxes, u0 and u within rtol 1e-9 of the JAX package."""
    tau, phi = np.linspace(0.0, 3.0, 5), np.array([0.0, 1.0, 4.0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")                     # NFourier > 64
        _, jfu, jfd, ju0, ju = pdt.pydisort(**column_kwargs(), NT_cor=True)
        _, fu, fd, u0, u = pt.pydisort(**column_kwargs(), NT_cor=True, device="cpu")
    ref = [jfu(tau), *jfd(tau), ju0(tau), ju(tau, phi)]
    out = [fu(tau), *fd(tau), u0(tau), u(tau, phi)]
    for lbl, a, b in zip(("flux_up", "flux_down diffuse", "flux_down direct", "u0", "u"), ref, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12 * np.abs(a).max(), err_msg=lbl)


def test_solve_fluxes_nquad68_matches_jax():
    """The batched flux path at NQuad = 68: 2 columns, 3 layers."""
    problem, tau = _problem(3, 1, True, False, False, True, True, S=2, nquad=NQ, seed=6)
    tau_eval = np.concatenate([tau * 0.5, tau], axis=1)
    ref = [np.asarray(x) for x in jax.jit(jax_solve_fluxes)(problem, jnp.asarray(tau_eval))]
    out = [x.numpy() for x in pt.solve_fluxes(to_port(problem), tau_eval)]
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref, out):
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-13 * np.abs(a).max(), err_msg=lbl)


def test_grad_nquad68_matches_jax():
    """d (flux_up + diffuse flux_down) / d omega through build_problem,
    solve and eval at NQuad = 68, 2 layers, against jax.grad, rtol 1e-8."""
    kw = dict(column_kwargs(L=2), only_flux=True)
    taus = [0.2, 0.9, 1.5]

    def jloss(omega):
        _, prob = jax_build_problem(**kw)
        prob.omega_arr = jnp.asarray(omega, prob.omega_arr.dtype)
        sol = pdt.solve(prob)
        t = jnp.asarray(taus)
        return jnp.sum(jev.flux_up(sol, t)) + jnp.sum(jev.flux_down(sol, t)[0])

    omega0 = kw["omega_arr"]
    g_ref = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(omega0)))
    _, prob = pt.build_problem(**kw, device="cpu")
    prob.omega_arr = torch.tensor(omega0, dtype=f64, requires_grad=True)
    sol = pt.solve(prob)
    t = torch.tensor(taus, dtype=f64)
    (ev.flux_up(sol, t).sum() + ev.flux_down(sol, t)[0].sum()).backward()
    g = prob.omega_arr.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, g_ref, rtol=1e-8, atol=1e-11 * np.abs(g_ref).max())


# ------------------------------------------------ the wide kernels' wrappers
def test_wide_wrappers_take_cuda_tensors_only():
    """Kernels 5 and 6 raise for a CPU tensor, with their device workspace
    or without: only `jacobi_eigh_lanes_raw` and
    `solve_block_tridiag_lanes_cuda` dispatch on the device."""
    blocks = [torch.zeros((2, 66, 66, 1), dtype=f64) for _ in range(3)]
    for workspace in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_jacobi.jacobi_eigh_lanes_wide(torch.eye(3, dtype=f64)[:, :, None].contiguous(), 12, workspace)
        with pytest.raises(ValueError, match="CUDA"):
            cuda_blocktri.solve_block_tridiag_lanes_wide(*blocks, torch.zeros((2, 66, 1), dtype=f64), workspace)


def test_wide_slot_table():
    """Kernel 5's slot table is the schedule, plus the idle row at odd n."""
    for n in (1, 2, 5, 8):
        table = cuda_jacobi.slot_table(n, "cpu").numpy()
        p, q = jacobi._round_robin_schedule(n)
        assert table.shape == (p.shape[0], (n + 1) // 2, 2)
        np.testing.assert_array_equal(table[:, : p.shape[1], 0], p)
        np.testing.assert_array_equal(table[:, : p.shape[1], 1], q)
        if n % 2:
            assert (table[:, -1, 1] == -1).all()
            for r, idle in enumerate(table[:, -1, 0]):
                assert idle not in p[r] and idle not in q[r]
