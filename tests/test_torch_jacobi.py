"""The port's two-sided Jacobi eigendecomposition held against the JAX
package (CPU, float64).

Inputs are symmetric matrices made with numpy from a seed, ``Q diag(lam)
Q^T`` with a random orthogonal ``Q``.  On CPU tensors the port runs its
plain lanes Jacobi (``ops.jacobi.jacobi_eigh_lanes_plain``), which
mirrors the JAX package's plain jnp Jacobi (``_jacobi_lanes_jnp``, what
``jacobi_eigh_lanes_raw`` runs on the CPU) operation for operation, so
even the unsorted eigenvectors agree to roundoff.  The gradient rule of
``jacobi_eigh`` is held to ``jax.grad``, to ``torch.autograd.gradcheck``
and to finite differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pythonic_disort_tpu.ops import jacobi as jjac
from pythonic_disort_torch.ops import cuda_jacobi, jacobi


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _spd(n, batch, seed, spread=1.0):
    """Symmetric (batch, n, n) with eigenvalues 1, 1 + spread, ... (well
    separated), in random orthogonal bases."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((batch, n, n)))
    lam = 1.0 + spread * np.arange(n) + 0.1 * rng.uniform(size=(batch, n))
    return np.einsum("bij,bj,bkj->bik", Q, lam, Q)


def _lanes(A):
    return np.ascontiguousarray(np.moveaxis(A, 0, -1))


@pytest.mark.parametrize("n,B", [(2, 5), (4, 9), (8, 6), (16, 4)])
def test_plain_lanes_jacobi_matches_jax(n, B):
    At = _lanes(_spd(n, B, seed=n))
    w_ref, V_ref = (np.asarray(x) for x in jjac.jacobi_eigh_lanes_raw(jnp.asarray(At)))
    w, V = (x.numpy() for x in jacobi.jacobi_eigh_lanes_raw(torch.as_tensor(At)))
    # the same rotations in the same order, 9 sweeps: unsorted w and V
    # agree to roundoff
    np.testing.assert_allclose(w, w_ref, rtol=1e-10)
    np.testing.assert_allclose(V, V_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [4, 8])
def test_jacobi_eigh_sorted_matches_jax(n):
    A = _spd(n, 6, seed=20 + n).reshape(2, 3, n, n)
    w_ref, V_ref = (np.asarray(x) for x in jjac.jacobi_eigh(jnp.asarray(A)))
    w, V = (x.numpy() for x in jacobi.jacobi_eigh(torch.as_tensor(A)))
    assert w.shape == (2, 3, n) and V.shape == (2, 3, n, n)
    assert np.all(np.diff(w, axis=-1) > 0)
    np.testing.assert_allclose(w, w_ref, rtol=1e-10)
    np.testing.assert_allclose(V, V_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_tied_diagonals_orthogonal_and_reconstruct(n):
    """Matrices whose diagonal entries tie exactly (all equal, or in equal
    pairs): the rotation of a tied pair has theta = 0 and turns by 45
    degrees (a constant diagonal ties every pair in every round)."""
    rng = np.random.default_rng(n)
    S = rng.standard_normal((4, n, n))
    A = 0.3 * (S + np.swapaxes(S, 1, 2))
    idx = np.arange(n)
    A[:, idx, idx] = 0.0
    A[0, idx, idx] = 2.0                                 # constant diagonal
    A[1, idx, idx] = np.repeat(np.arange(n // 2), 2)     # tied pairs
    A[2, idx, idx] = 1.5
    A[2] = np.where(np.abs(idx[:, None] - idx[None, :]) == 1, A[2], np.diag(np.full(n, 1.5)))
    A[3, idx, idx] = rng.permutation(np.repeat(np.arange(n // 2), 2))
    w, V = (x.numpy() for x in jacobi.jacobi_eigh(torch.as_tensor(A)))
    eye = np.eye(n)
    assert np.abs(np.swapaxes(V, 1, 2) @ V - eye).max() < 1e-13
    recon = np.einsum("bij,bj,bkj->bik", V, w, V)
    assert np.abs(recon - A).max() < 1e-13 * np.abs(A).max()
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("sort", [True, False])
def test_jacobi_eigh_gradcheck(sort):
    """gradcheck of a loss invariant to the signs of the eigenvectors, on
    A = (X + X^T) / 2 so that every perturbation stays symmetric."""
    n = 4
    X = torch.as_tensor(_spd(n, 2, seed=31), dtype=torch.float64).requires_grad_()
    rng = np.random.default_rng(32)
    cw = torch.as_tensor(rng.standard_normal((2, n)))
    cv = torch.as_tensor(rng.standard_normal((2, n, n)))

    def loss(X):
        w, V = jacobi.jacobi_eigh(0.5 * (X + X.mT), sort=sort)
        return (w * cw).sum() + (V * V * cv).sum()

    assert torch.autograd.gradcheck(loss, (X,), eps=1e-6, atol=1e-7, rtol=1e-6)


def test_jacobi_grad_degenerate_eigenvalues():
    """Counterpart of tests/test_grad.py::test_jacobi_jvp_degenerate_eigenvalues:
    a pair 1e-9 apart; the gradient of a symmetric function of the
    spectrum stays finite and matches jax.grad and finite differences."""
    rng = np.random.default_rng(3)
    Qm, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    lam = np.array([0.5, 1.0, 1.0 + 1e-9, 2.0, 3.0, 4.0])
    A0 = (Qm * lam) @ Qm.T
    S = rng.standard_normal((6, 6)) * 0.1

    def jloss(t):
        w, _ = jjac.jacobi_eigh((jnp.asarray(A0) + t * jnp.asarray(S + S.T))[None])
        return jnp.sum(w**2)

    def loss(t):
        w, _ = jacobi.jacobi_eigh((torch.as_tensor(A0) + t * torch.as_tensor(S + S.T))[None])
        return (w**2).sum()

    t = torch.zeros((), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(t), t)
    g = float(g)
    assert np.isfinite(g)
    g_ref = float(jax.grad(jloss)(jnp.asarray(0.0)))
    np.testing.assert_allclose(g, g_ref, rtol=1e-8)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-6)


@pytest.mark.parametrize("n", [3, 5])
def test_odd_n_schedule_and_eigenpairs(n):
    """Odd n, which the JAX package's schedule refuses: n rounds of
    (n-1)/2 disjoint pairs cover every pair once, and `jacobi_eigh`
    returns the eigenpairs of LAPACK's eigh (float64 roundoff)."""
    p, q = jacobi._round_robin_schedule(n)
    assert p.shape == (n, (n - 1) // 2)
    assert sorted(zip(p.ravel(), q.ravel())) == [(i, j) for i in range(n) for j in range(i + 1, n)]
    A = _spd(n, 4, seed=40 + n)
    w, V = (x.numpy() for x in jacobi.jacobi_eigh(torch.as_tensor(A)))
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A), rtol=1e-12)
    np.testing.assert_allclose(np.einsum("bij,bj,bkj->bik", V, w, V), A, atol=1e-12 * np.abs(A).max())


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The kernel's wrapper raises for a CPU tensor rather than run the
    plain version: only `jacobi_eigh_lanes_raw` dispatches on the device."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_jacobi.jacobi_eigh_lanes(torch.eye(4, dtype=torch.float64)[:, :, None].contiguous(), 9)
