"""The port's eigen stage held against the JAX package (CPU, float64).

Inputs are built with numpy from a seed: physical scattering kernels
D+/D- (Henyey-Greenstein-like Legendre moments, single-scattering albedo
below 1) for one hemisphere of a double-Gauss rule.  They go through
``pythonic_disort_tpu.ops.eig.disort_eigh_lanes`` (on the CPU its plain
jnp Jacobi path) and ``pythonic_disort_torch.ops.eig.disort_eigh_lanes``
(on CPU tensors the plain stage, Cholesky and the plain two-sided
Jacobi).  No comparison depends on the order of the eigen columns.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pythonic_disort_tpu.ops.eig import disort_eigh as jax_eigh
from pythonic_disort_tpu.ops.eig import disort_eigh_lanes as jax_eigh_lanes
from pythonic_disort_torch.ops import cuda_eig
from pythonic_disort_torch.ops.eig import disort_eigh, disort_eigh_lanes
from pythonic_disort_torch.ops.quadrature import double_gauss
from pythonic_disort_torch.utils import profiling
from test_torch_eig_f32 import lapack_stage


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
    # the two f64 Jacobi stages (9 sweeps) agree on K to roundoff
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
    before = profiling.recorded()["launches"]
    K, *_ = disort_eigh_lanes(t(Dp), t(Dm), t(mu), t(w))
    assert profiling.recorded()["launches"] == before
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


# ---------------------------------------------------------------------------
# csrc/eig_stage.cu's order of operations, modelled in numpy and held to the
# JAX package's one-sided Jacobi and to LAPACK before the kernel is built.

def _kernel_partners(n, rounds):
    """Partner of every row in `rounds` consecutive rounds, from the
    kernel's closed form of the circle method: q = (max(i - 1, 0) + r)
    mod (n - 1), advanced once a round."""
    m1 = n - 1
    q = [max(i - 1, 0) for i in range(n)]
    out = []
    for _ in range(rounds):
        row = [m1 - q[0]]
        for i in range(1, n):
            v = m1 - 2 + (i - 1) - 2 * q[i]
            v = v + m1 if v < 0 else v - m1 if v >= m1 else v
            row.append(0 if q[i] == m1 - 1 else 1 + v)
        out.append(row)
        q = [0 if x + 1 == m1 else x + 1 for x in q]
    return np.array(out)


def _pad_rows(x, rows):
    """(B, n, n) -> (B, rows, rows), identity rows and columns past n: a
    matrix as the kernel holds it in rows of ``rows`` entries."""
    B, n, _ = x.shape
    out = np.broadcast_to(np.eye(rows), (B, rows, rows)).copy()
    out[:, :n, :n] = x
    return out


def _chol_rows_model(a, n=None):
    """The kernel's row Cholesky on (B, rows, rows) rows, of which the
    first n are the matrix (rows past n identity rows): step k < n reads
    column k of the trailing matrix, takes one reciprocal of its pivot's
    square root and updates every row below.  Returns L and 1 / diag(L)
    (1 past n)."""
    a = a.copy()
    B, rows, _ = a.shape
    n = rows if n is None else n
    ids = np.arange(rows)[None, :]
    rdiag = np.ones((B, rows))
    for k in range(n):
        col = a[:, :, k].copy()
        d = np.sqrt(col[:, k])
        r = 1.0 / d
        w = np.where(ids > k, a[:, :, k] * r[:, None] * r[:, None], 0.0)
        a[:, :, k + 1:] -= w[:, :, None] * col[:, None, k + 1:]
        rdiag[:, k] = r
        a[:, :, k] = np.where(ids > k, a[:, :, k] * r[:, None], np.where(ids == k, d[:, None], 0.0))
    return a, rdiag


def _partial_sums(prod):
    """Four partial sums over the last axis, entries m = 0, 1, 2, 3 mod 4,
    each accumulated in order of m, as the kernel's unrolled dot."""
    s = [np.zeros(prod.shape[:-1]) for _ in range(4)]
    for m in range(prod.shape[-1]):
        s[m % 4] = s[m % 4] + prod[..., m]
    return (s[0] + s[1]) + (s[2] + s[3])


def _sweeps_model(c, sweeps, n=None):
    """The kernel's one-sided Jacobi on the rows of c (B, rows, rows), of
    which the first n take part (the rest pair with themselves): rolled
    rounds with closed-form partners, the dot in four partial sums, the
    norm summed in order, the cosine as rsqrt(1 + t^2) with two Newton
    steps.  Returns (K^2, Z^T)."""
    B, rows, _ = c.shape
    n = rows if n is None else n
    w = np.broadcast_to(np.eye(rows), c.shape).copy()
    nrm = np.zeros((B, rows))
    for m in range(rows):
        nrm = nrm + c[..., m] * c[..., m]
    partners = np.concatenate([_kernel_partners(n, n - 1), np.tile(np.arange(n, rows), (n - 1, 1))], axis=1)
    for _ in range(sweeps):
        for p in partners:
            pc = c[:, p, :]
            offd = _partial_sums(c * pc)
            theta = (nrm[:, p] - nrm) * 0.5
            denom = np.abs(theta) + np.sqrt(theta * theta + offd * offd)
            sgn = np.where(theta >= 0, 1.0, -1.0)
            t = np.where((np.abs(offd) > 0) & (theta != 0),
                         sgn * offd / np.where(denom > 0, denom, 1.0), 0.0)
            x = 1.0 + t * t
            cth = 1.0 / np.sqrt(x)
            cth = cth * (1.5 - 0.5 * x * cth * cth)
            cth = cth * (1.5 - 0.5 * x * cth * cth)
            sn = t * cth
            nrm = nrm - t * offd
            c = cth[..., None] * c - sn[..., None] * pc
            w = cth[..., None] * w - sn[..., None] * w[:, p, :]
    return _partial_sums(c * c), w


def _stage_model(At, Bt, sweeps, rows=None):
    """The kernel's eigen stage on lanes operands (n, n, B), its matrices
    held in rows of ``rows`` >= n entries (default n) with identity rows
    past n, its sums in the kernel's order; returns (K, V, Yr, Pr, Qr) in
    the lanes layout and C, the Cholesky factor of M."""
    n, B = At.shape[0], At.shape[2]
    rows = n if rows is None else rows
    A = -np.moveaxis(At, 2, 0)
    L, rd = _chol_rows_model(_pad_rows(-np.moveaxis(Bt, 2, 0), rows), n)
    T1 = np.zeros((B, rows, rows))                  # (-At) L, zero rows past n
    for j in range(n):
        T1[:, :n, :] += A[:, :, j, None] * L[:, None, j, :]
    M = np.zeros((B, rows, rows))                   # L^T T1, identity rows past n
    for j in range(n):
        M += L[:, j, :, None] * T1[:, None, j, :]
    M[:, n:, :] = np.eye(rows)[n:]
    C, _ = _chol_rows_model(M, n)
    k2, w = _sweeps_model(C, sweeps, n)
    K = np.sqrt(np.maximum(k2, np.finfo(np.float64).tiny))
    Z = np.swapaxes(w, 1, 2)
    LZ = np.zeros((B, rows, rows))
    for k in range(n):
        LZ += L[:, :, k, None] * Z[:, None, k, :]
    V = Z.copy()
    for j in range(n - 1, -1, -1):
        V[:, j, :] *= rd[:, j, None]
        V[:, :j, :] -= L[:, j, :j, None] * V[:, j, None, :]
    Yr = -LZ * (1.0 / K)[:, None, :]
    Pr = np.swapaxes(LZ, 1, 2)
    Qr = -K[:, :, None] * np.swapaxes(V, 1, 2)
    lanes = lambda x: np.moveaxis(x[:, :n, :n], 0, -1)
    return (K[:, :n].T, *(lanes(x) for x in (V, Yr, Pr, Qr))), C[:, :n, :n]


def _stage_operands(n, B, seed):
    Dp, Dm, mu, w = _kernels(n, B, seed)
    rho = np.sqrt(w / mu)
    outer = rho[:, None, None] * rho[None, :, None]
    inv_mu = np.diag(1 / mu)[:, :, None]
    return outer * (Dp - Dm) - inv_mu, outer * (Dp + Dm) - inv_mu


@pytest.mark.parametrize("n", range(2, 33, 2))
def test_kernel_closed_form_partners_match_round_robin(n):
    """Three sweeps of the kernel's partner state give the partner table of
    `_round_robin_schedule` in every round."""
    from pythonic_disort_tpu.ops.jacobi import _round_robin_schedule

    p_sched, q_sched = _round_robin_schedule(n)
    table = np.empty((n - 1, n), dtype=int)
    for r in range(n - 1):
        table[r, p_sched[r]], table[r, q_sched[r]] = q_sched[r], p_sched[r]
    np.testing.assert_array_equal(_kernel_partners(n, 3 * (n - 1)), np.tile(table, (3, 1)))


@pytest.mark.parametrize("n", [2, 4, 16, 24, 32])
def test_kernel_sweep_model_matches_jax_onesided(n):
    """The kernel's sweeps (model) against `pallas_jacobi.onesided_sweeps`
    on the same C, float64, 9 sweeps: the same schedule and rotations, so
    K^2 and Z^T agree entry by entry to roundoff."""
    from pythonic_disort_tpu.ops.pallas_jacobi import _partner_perms, onesided_sweeps

    At, Bt = _stage_operands(n, 6, seed=40 + n)
    _, C = _stage_model(At, Bt, 0)
    k2, w = _sweeps_model(C, 9)
    # eager: compiling the fori_loop body of 31 unrolled rounds takes a minute
    with jax.disable_jit():
        k2_ref, w_ref = onesided_sweeps(jnp.asarray(np.moveaxis(C, 0, -1)), n=n, sweeps=9, perms=_partner_perms(n))
    k2_ref, w_ref = np.asarray(k2_ref).T, np.moveaxis(np.asarray(w_ref), -1, 0)
    np.testing.assert_allclose(k2, k2_ref, rtol=1e-10, atol=1e-12 * np.abs(k2_ref).max())
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [2, 4, 16, 24, 32])
def test_kernel_stage_model_matches_lapack(n):
    """The kernel's whole stage (model) against the stage on LAPACK's eigh
    (`test_torch_eig_f32.lapack_stage`) in float64, 9 sweeps, with the
    order-free readings and float64 limits of `tools/check_eig.py`."""
    from pythonic_disort_torch.tools.check_eig import eig_errors, beyond_limits

    At, Bt = _stage_operands(n, 12, seed=60 + n)
    outs, _ = _stage_model(At, Bt, cuda_eig.jacobi_sweeps(torch.float64))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    Kp = lapack_stage(t(At), t(Bt))[0]
    e = eig_errors(t(At), t(Bt), tuple(t(x) for x in outs), Kp)
    assert not beyond_limits(e, torch.float64), e


@pytest.mark.parametrize("n", [18, 20, 22, 24])
def test_kernel_stage_model_rows_of_24_match_rows_of_32_bit_for_bit(n):
    """At 16 < n <= 24 the kernel holds its rows in 24 entries where it
    held them in 32: the padding past n (identity rows, zero columns) adds
    only exact zeros to its sums, so the model's outputs in float64 at 9
    sweeps are the same bits at either capacity."""
    At, Bt = _stage_operands(n, 8, seed=80 + n)
    sweeps = cuda_eig.jacobi_sweeps(torch.float64)
    outs24, _ = _stage_model(At, Bt, sweeps, rows=24)
    outs32, _ = _stage_model(At, Bt, sweeps, rows=32)
    for name, a, b in zip(("K", "V", "Yr", "Pr", "Qr"), outs24, outs32):
        assert a.shape == b.shape and np.array_equal(a, b), name
