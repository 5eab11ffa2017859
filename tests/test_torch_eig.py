"""The port's eigen stage held against the JAX package (CPU, float64).

Inputs are built with numpy from a seed: physical scattering kernels
D+/D- (Henyey-Greenstein-like Legendre moments, single-scattering albedo
below 1) for one hemisphere of a double-Gauss rule.  They go through
``pythonic_disort_tpu.ops.eig.disort_eigh_lanes`` (on the CPU its plain
jnp Jacobi path) and ``pythonic_disort_torch.ops.eig.disort_eigh_lanes``
(on CPU tensors the plain torch.linalg stage).  The two order their eigen
columns differently, so every comparison is order-free.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pythonic_disort_tpu.ops.eig import disort_eigh as jax_eigh
from pythonic_disort_tpu.ops.eig import disort_eigh_lanes as jax_eigh_lanes
from pythonic_disort_torch.ops import cuda_eig
from pythonic_disort_torch.ops.eig import disort_eigh, disort_eigh_lanes
from pythonic_disort_torch.ops.quadrature import double_gauss


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _kernels(n, B, seed):
    """D+, D- (n, n, B) for random albedo and asymmetry, plus mu, w."""
    rng = np.random.default_rng(seed)
    mu, w = double_gauss(2 * n)
    nleg = 2 * n
    omega = rng.uniform(0.2, 0.99, B)
    g = rng.uniform(0.0, 0.9, B)
    ell = np.arange(nleg)
    coef = (omega[:, None] / 2) * (2 * ell + 1) * g[:, None] ** ell     # (B, nleg)
    P = np.polynomial.legendre.legvander(mu, nleg - 1)                 # (n, nleg)
    parity = (-1.0) ** ell
    Dp = np.einsum("il,jl,bl->ijb", P, P, coef)
    Dm = np.einsum("il,jl,bl->ijb", P, P * parity, coef)
    return Dp, Dm, mu, w


def _residuals(Dp, Dm, mu, w, K, X, Y, P, Q):
    """Order-free checks on the physical eigenbasis, each relative."""
    Bt = Dp.shape[-1]
    M_inv = np.diag(1 / mu)
    alpha = np.einsum("ij,jkb->ikb", M_inv, Dp * w[None, :, None]) - M_inv[:, :, None]
    beta = np.einsum("ij,jkb->ikb", M_inv, Dm * w[None, :, None])
    S = np.einsum("ijb,jkb->ikb", alpha - beta, alpha + beta)
    SX = np.einsum("ijb,jkb->ikb", S, X)
    eye = np.eye(K.shape[0])[:, :, None]
    r_eig = np.abs(SX - X * K[None] ** 2).max() / (np.abs(S).max() * np.abs(X).max())
    ApbX = np.einsum("ijb,jkb->ikb", alpha + beta, X)
    r_y = np.abs(Y - ApbX / K[None]).max() / np.abs(Y).max()
    r_p = np.abs(np.einsum("ijb,jkb->ikb", P, X) - eye).max()
    r_q = np.abs(np.einsum("ijb,jkb->ikb", Q, Y) - eye).max()
    assert Bt == K.shape[1]
    return r_eig, r_y, r_p, r_q


@pytest.mark.parametrize("n,B", [(2, 7), (4, 33), (8, 64), (16, 40)])
def test_eig_stage_matches_jax(n, B):
    Dp, Dm, mu, w = _kernels(n, B, seed=n)
    ref = [np.asarray(x) for x in jax_eigh_lanes(
        jnp.asarray(Dp), jnp.asarray(Dm), jnp.asarray(mu), jnp.asarray(w))]
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    out = [x.numpy() for x in disort_eigh_lanes(t(Dp), t(Dm), t(mu), t(w))]
    # f64 Jacobi (9 sweeps) and LAPACK's eigh agree on K to roundoff
    # grown by the conditioning of -Bt (its 1/mu diagonal spans up to
    # ~200x at n = 16): 1e-10 relative leaves a wide margin.
    k_ref = np.sort(ref[0], axis=0)
    k_out = np.sort(out[0], axis=0)
    np.testing.assert_allclose(k_out, k_ref, rtol=1e-10, atol=0)
    # both bases satisfy the defining relations to f64 roundoff
    for name, res in (("port", _residuals(Dp, Dm, mu, w, *out)),
                      ("jax", _residuals(Dp, Dm, mu, w, *ref))):
        assert max(res) < 1e-10, f"{name}: residuals {res}"


@pytest.mark.parametrize("n,batch", [(4, (3, 5)), (8, (6,)), (2, ())])
def test_padded_eigh_matches_jax(n, batch):
    """`disort_eigh` on (*batch, N, N) operands: the same order-free
    readings as the lanes interface, per batch element."""
    B = int(np.prod(batch, dtype=int))
    Dp, Dm, mu, w = _kernels(n, B, seed=20 + n)
    pad = lambda x: np.moveaxis(x, 2, 0).reshape(batch + (n, n))
    ref = [np.asarray(x) for x in jax_eigh(
        jnp.asarray(pad(Dp)), jnp.asarray(pad(Dm)), jnp.asarray(mu), jnp.asarray(w))]
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    out = [x.numpy() for x in disort_eigh(t(pad(Dp)), t(pad(Dm)), t(mu), t(w))]
    assert out[0].shape == batch + (n,) and all(x.shape == batch + (n, n) for x in out[1:])
    # sorted K to roundoff (see test_eig_stage_matches_jax)
    np.testing.assert_allclose(np.sort(out[0], axis=-1), np.sort(ref[0], axis=-1), rtol=1e-10, atol=0)
    lanes = lambda x: np.moveaxis(x.reshape((B,) + x.shape[len(batch):]), 0, -1)
    res = _residuals(Dp, Dm, mu, w, *(lanes(x) for x in out))
    assert max(res) < 1e-10, f"residuals {res}"


def test_eig_stage_plain_matches_lanes_definition():
    """The plain stage's raw outputs obey V = L^-T Z, Yr = -L Z / K,
    Pr = (L Z)^T, Qr = -K V^T for an orthonormal Z."""
    Dp, Dm, mu, w = _kernels(8, 16, seed=3)
    rho = np.sqrt(w / mu)
    At = rho[:, None, None] * rho[None, :, None] * (Dp - Dm) - np.diag(1 / mu)[:, :, None]
    Bt = rho[:, None, None] * rho[None, :, None] * (Dp + Dm) - np.diag(1 / mu)[:, :, None]
    K, V, Yr, Pr, Qr = (x.numpy() for x in cuda_eig.eig_stage_lanes_plain(
        torch.as_tensor(At), torch.as_tensor(Bt)))
    for b in range(At.shape[-1]):
        L = np.linalg.cholesky(-Bt[..., b])
        Z = L.T @ V[..., b]
        np.testing.assert_allclose(Z.T @ Z, np.eye(8), atol=1e-12)
        np.testing.assert_allclose(Yr[..., b], -(L @ Z) / K[:, b], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Pr[..., b], (L @ Z).T, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Qr[..., b], -K[:, b, None] * V[..., b].T, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.sort(K[:, b] ** 2),
                                   np.sort(np.linalg.eigvals(At[..., b] @ Bt[..., b]).real),
                                   rtol=1e-10)


def test_eig_wrapper_cpu_takes_plain_and_counts_no_launch():
    Dp, Dm, mu, w = _kernels(4, 5, seed=1)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    before = cuda_eig.eig_stage_lanes.launches
    K, *_ = disort_eigh_lanes(t(Dp), t(Dm), t(mu), t(w))
    assert cuda_eig.eig_stage_lanes.launches == before
    assert K.shape == (4, 5)


def test_eig_wrapper_refuses_non_cuda_non_cpu_tensors():
    At = torch.empty((4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_eig.eig_stage_lanes(At, At)


@pytest.mark.parametrize("dtype,sweeps", [(torch.float32, 5), (torch.float64, 9)])
def test_jacobi_sweeps_match_jax_default(dtype, sweeps):
    from pythonic_disort_tpu.ops.jacobi import default_sweeps

    assert cuda_eig.jacobi_sweeps(dtype) == sweeps
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    assert default_sweeps(16, jdt) == sweeps
