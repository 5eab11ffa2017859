"""The port's block-tridiagonal solves held against the JAX package (CPU,
float64).

Operands come from numpy with a seed.  For the fused boundary-value
solve: well-conditioned eigenvector blocks G (identity plus a small
random part), decays in (0.05, 0.95), bottom boundary rows and right-hand
sides; the JAX side assembles the blocks
(``ops.blocktri.assemble_bvp_blocks``) and runs its lanes block-Thomas
(``solve_block_tridiag_lanes``, the plain jnp path on the CPU); the port
runs ``ops.cuda_blocktri.solve_bvp_fused``, which on CPU tensors is its
plain assemble + pivoted block-Thomas.  For the generic solve: dense
blocks with no structural zeros, through the lanes and the padded
interfaces of both packages.  The solution is unique, so x is compared
directly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pythonic_disort_tpu.ops import blocktri as jbt
from pythonic_disort_torch.ops import blocktri, cuda_blocktri
from pythonic_disort_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _operands(L, N, B, seed):
    rng = np.random.default_rng(seed)
    n2 = 2 * N
    Gt = np.eye(n2)[None, :, :, None] + 0.3 * rng.standard_normal((L, n2, n2, B)) / np.sqrt(n2)
    decay = rng.uniform(0.05, 0.95, (L, N, B))
    bt_rows = np.concatenate(
        [np.eye(N)[:, :, None] + 0.2 * rng.standard_normal((N, N, B)),
         0.2 * rng.standard_normal((N, N, B))], axis=1)
    rhs = rng.standard_normal((L, n2, B))
    return Gt, decay, bt_rows, rhs


@pytest.mark.parametrize("L,N,B", [(1, 2, 5), (2, 4, 9), (5, 4, 16), (8, 8, 3)])
def test_bvp_solve_matches_jax(L, N, B):
    ops = _operands(L, N, B, seed=10 * L + N)
    jops = [jnp.asarray(x) for x in ops]
    lower, diag, upper = jbt.assemble_bvp_blocks(*jops[:3])
    x_ref = np.asarray(jbt.solve_block_tridiag_lanes(lower, diag, upper, jops[3]))
    x = cuda_blocktri.solve_bvp_fused(*(torch.as_tensor(o) for o in ops)).numpy()
    # the same pivoted elimination in f64 on a well-conditioned system:
    # agreement to roundoff, 1e-10 relative leaves a wide margin
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12 * np.abs(x_ref).max())


def _h_carry_model(Gt, decay, bt_rows, rhs):
    """numpy model of the fused solve's H-carry block Thomas, one lane at
    a time (the order of operations of the retired kernel 2; kernel 7,
    ``csrc/bvp_fused_wide.cu``, keeps it but for the order of its sums,
    which ``tests/test_torch_bvp_wide.py`` models): the blocks assembled from
    G, the decays and the boundary rows; the correction
    ``dhat[:N] = D[:N] + C Mbot_l[:N]`` with ``C = Mtop_{l-1}[N:] [H | g]``
    of the layer before; Gauss-Jordan on ``[dhat | [0; I_N] | rhat]`` with
    no row exchanges, the pivot the largest |entry| of the column among
    the rows not yet pivoted (the lowest row winning a tie), one reciprocal
    a step and the scaling deferred to the copy-out; the last layer over
    ``[dhat | rhat]`` alone; back substitution ``x_l = g_l + H_l (Mbot_{l+1}[:N]
    x_{l+1})``.  Returns x (L, 2N, B) and the number of pivots taken off
    the diagonal."""
    L, n2, _, B = Gt.shape
    N = n2 // 2
    x = np.empty((L, n2, B))
    off_diagonal = 0
    for b in range(B):
        G, d, r = Gt[..., b], decay[..., b], rhs[..., b]
        Mtop = [np.concatenate([G[l][:, :N] * d[l], G[l][:, N:]], axis=1) for l in range(L)]
        Mbot = [np.concatenate([G[l][:, :N], G[l][:, N:] * d[l]], axis=1) for l in range(L)]
        Hs, gs = [], []
        for l in range(L):
            last = l == L - 1
            D = np.concatenate([(1.0 if l == 0 else -1.0) * Mbot[l][N:], bt_rows[..., b] if last else Mtop[l][:N]])
            a = np.concatenate([D] + ([] if last else [np.eye(n2)[:, N:]]) + [r[l][:, None]], axis=1)
            if l > 0:
                C = Mtop[l - 1][N:] @ np.concatenate([Hs[-1], gs[-1][:, None]], axis=1)
                a[:N, :n2] += C[:, :N] @ Mbot[l][:N]
                a[:N, -1] -= C[:, N]
            used = np.zeros(n2, bool)
            var, rcp = np.empty(n2, int), np.empty(n2)
            for k in range(n2):
                pr = int(np.argmax(np.where(used, -1.0, np.abs(a[:, k]))))
                rpv = 1.0 / a[pr, k]
                others = np.arange(n2) != pr
                a[others, k + 1:] -= (a[others, k] * rpv)[:, None] * a[pr, k + 1:]
                used[pr], var[pr], rcp[pr] = True, k, rpv
            off_diagonal += int((var != np.arange(n2)).sum())
            sol = np.empty((n2, a.shape[1] - n2))
            sol[var] = a[:, n2:] * rcp[:, None]
            Hs.append(sol[:, :-1])
            gs.append(sol[:, -1])
        x[L - 1, :, b] = gs[-1]
        for l in range(L - 2, -1, -1):
            x[l, :, b] = gs[l] + Hs[l] @ (Mbot[l + 1][:N] @ x[l + 1, :, b])
    return x, off_diagonal


@pytest.mark.parametrize("L,N,zero_lead", [(1, 1, False), (3, 3, False), (5, 8, False), (4, 3, True)])
def test_fused_kernel_order_of_operations_matches_jax(L, N, zero_lead):
    """The fused kernel's algorithm, modelled in numpy, against the JAX
    package's assembled blocks and block Thomas (float64)."""
    ops = _operands(L, N, 3, seed=50 + 10 * L + N)
    if zero_lead:
        # D_0[0, 0] = Mbot_0[N, 0] = 0: an unpivoted elimination divides by zero
        ops[0][:, N, 0, :] = 0.0
    jops = [jnp.asarray(x) for x in ops]
    x_ref = np.asarray(jbt.solve_block_tridiag_lanes(*jbt.assemble_bvp_blocks(*jops[:3]), jops[3]))
    x, off_diagonal = _h_carry_model(*ops)
    # the operands' dominant entries of D's first N columns lie in its bottom rows
    assert off_diagonal > 0
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12 * np.abs(x_ref).max())


@pytest.mark.parametrize("L", [1, 3])
def test_assemble_bvp_blocks_matches_jax(L):
    ops = _operands(L, 3, 4, seed=L)
    ref = jbt.assemble_bvp_blocks(*(jnp.asarray(x) for x in ops[:3]))
    out = blocktri.assemble_bvp_blocks(*(torch.as_tensor(x) for x in ops[:3]))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_gauss_jordan_pivots():
    """A zero leading entry needs a row exchange; unpivoted elimination
    would divide by zero (the Stamnes 4c failure mode)."""
    rng = np.random.default_rng(0)
    n, m, b = 6, 3, 5
    D = rng.standard_normal((n, n, b))
    D[0, 0, :] = 0.0
    Aug = rng.standard_normal((n, m, b))
    X = blocktri.gauss_jordan_solve_lanes(torch.as_tensor(D), torch.as_tensor(Aug)).numpy()
    for k in range(b):
        np.testing.assert_allclose(X[..., k], np.linalg.solve(D[..., k], Aug[..., k]),
                                   rtol=1e-11, atol=1e-12)


def test_bvp_wrapper_cpu_takes_plain_and_counts_no_launch():
    ops = [torch.as_tensor(o) for o in _operands(3, 2, 4, seed=5)]
    before = profiling.recorded()["launches"]
    x = cuda_blocktri.solve_bvp_fused(*ops)
    assert profiling.recorded()["launches"] == before
    torch.testing.assert_close(x, cuda_blocktri.solve_bvp_fused_plain(*ops), rtol=0, atol=0)


def test_bvp_wrapper_refuses_non_cuda_non_cpu_tensors():
    ops = [torch.empty(s, device="meta") for s in ((2, 4, 4, 8), (2, 2, 8), (2, 4, 8), (2, 4, 8))]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blocktri.solve_bvp_fused(*ops)


def _dense_blocks(L, n, B, seed, permute=False):
    """General dense blocks with a dominant diagonal, rhs, and NaN in the
    two blocks the convention ignores."""
    rng = np.random.default_rng(seed)
    lower, upper = (0.5 * rng.standard_normal((L, n, n, B)) / np.sqrt(n) for _ in range(2))
    diag = 3 * np.eye(n)[None, :, :, None] + rng.standard_normal((L, n, n, B)) / np.sqrt(n)
    rhs = rng.standard_normal((L, n, B))
    if permute:
        # one row permutation of every block row: x stays, the leading
        # entries stop being the largest of their columns
        perm = np.roll(np.arange(n), 1)
        lower, diag, upper, rhs = lower[:, perm], diag[:, perm], upper[:, perm], rhs[:, perm]
    lower[0], upper[-1] = np.nan, np.nan
    return lower, diag, upper, rhs


def _dense_reference(ops):
    """x by numpy's dense solve of each lane's assembled system."""
    lower, diag, upper, rhs = ops
    L, n, _, B = diag.shape
    x = np.empty((L, n, B))
    for b in range(B):
        A = np.zeros((L * n, L * n))
        for l in range(L):
            A[l * n:(l + 1) * n, l * n:(l + 1) * n] = diag[l, :, :, b]
            if l > 0:
                A[l * n:(l + 1) * n, (l - 1) * n:l * n] = lower[l, :, :, b]
            if l < L - 1:
                A[l * n:(l + 1) * n, (l + 1) * n:(l + 2) * n] = upper[l, :, :, b]
        x[..., b] = np.linalg.solve(A, rhs[..., b].reshape(-1)).reshape(L, n)
    return x


@pytest.mark.parametrize("L,n,B", [(1, 4, 5), (2, 4, 1), (6, 4, 5), (1, 8, 1), (2, 8, 5), (6, 8, 1),
                                   (1, 48, 1), (2, 48, 5), (6, 48, 1)])
def test_generic_solve_matches_jax(L, n, B):
    ops = _dense_blocks(L, n, B, seed=100 * L + n + B)
    x_ref = np.asarray(jbt.solve_block_tridiag_lanes(*(jnp.asarray(o) for o in ops)))
    assert np.isfinite(x_ref).all()
    x = cuda_blocktri.solve_block_tridiag_lanes_cuda(*(torch.as_tensor(o) for o in ops)).numpy()
    # the same pivoted elimination in f64 on a well-conditioned system:
    # agreement to roundoff, 1e-10 relative leaves a wide margin
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12 * np.abs(x_ref).max())
    np.testing.assert_allclose(x, _dense_reference(ops), rtol=1e-9, atol=1e-11 * np.abs(x_ref).max())


@pytest.mark.parametrize("L,n,batch", [(1, 4, (3,)), (4, 6, (2, 3)), (3, 8, ())])
def test_padded_solve_matches_jax(L, n, batch):
    B = int(np.prod(batch, dtype=int))
    lanes = _dense_blocks(L, n, B, seed=7 * L + n)
    # (L, n, n, B) -> (L, *batch, n, n)
    mat = lambda x: np.moveaxis(x, 3, 1).reshape((L,) + batch + (n, n))
    padded = [mat(o) for o in lanes[:3]] + [np.moveaxis(lanes[3], 2, 1).reshape((L,) + batch + (n,))]
    x_ref = np.asarray(jbt.solve_block_tridiag(*(jnp.asarray(o) for o in padded)))
    x = blocktri.solve_block_tridiag(*(torch.as_tensor(o) for o in padded)).numpy()
    assert x.shape == (L,) + batch + (n,)
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12 * np.abs(x_ref).max())


def test_generic_solve_pivots():
    """Rows permuted so that every leading entry is small: the solve has to
    exchange rows, and x is what the unpermuted system gives."""
    plain = _dense_blocks(3, 6, 4, seed=3)
    rolled = _dense_blocks(3, 6, 4, seed=3, permute=True)
    assert np.abs(rolled[1][:, 0, 0]).max() < 1.0 < np.abs(plain[1][:, 0, 0]).min()
    x = cuda_blocktri.solve_block_tridiag_lanes_cuda(*(torch.as_tensor(o) for o in rolled)).numpy()
    x_ref = np.asarray(jbt.solve_block_tridiag_lanes(*(jnp.asarray(o) for o in rolled)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12 * np.abs(x_ref).max())
    np.testing.assert_allclose(x, _dense_reference(plain), rtol=1e-9, atol=1e-11 * np.abs(x_ref).max())


def test_generic_wrapper_cpu_takes_plain_and_counts_no_launch():
    ops = [torch.as_tensor(o) for o in _dense_blocks(3, 4, 2, seed=5)]
    before = profiling.recorded()["launches"]
    x = cuda_blocktri.solve_block_tridiag_lanes_cuda(*ops)
    assert profiling.recorded()["launches"] == before
    torch.testing.assert_close(x, blocktri.solve_block_tridiag_lanes(*ops), rtol=0, atol=0)


def test_generic_wrapper_refuses_non_cuda_non_cpu_tensors():
    ops = [torch.empty(s, device="meta") for s in ((2, 4, 4, 8),) * 3 + ((2, 4, 8),)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blocktri.solve_block_tridiag_lanes_cuda(*ops)
