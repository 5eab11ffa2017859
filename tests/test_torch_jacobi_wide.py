"""The order of operations of kernel 5's register body
(``pythonic_disort_torch/csrc/jacobi_eigh_wide.cu``, ``jacobi_wide_reg_kernel``),
modelled in numpy and held against the port's plain Jacobi
(``ops/jacobi.py::jacobi_eigh_lanes_plain``) and the JAX package's
``jacobi_eigh`` (CPU, float64).

The model follows the kernel's layout and order: the matrix is held in
the schedule's position order, slot k of a round pairing positions k and
N-1-k (N = n rounded up to even, an odd n's extra row and column zero);
lane k of a matrix's first warp holds the rows of A at positions k and
N-1-k and, with one warp a matrix, rows k and k + MP of V (with two, the
second warp's lane k holds those), each row as two arrays by column slot j
(positions j and N-1-j); lane k names the rows it holds in closed form,
takes its 2 x 2 diagonal block from the shift scratch, computes its slot's
(c, s) from A[p][q] (p < q) with the sign of s flipped where its top row
is q, and writes it to the (c, s) table (every other lane writes the
identity); the first warp turns rows 0 and 1 with the lane's own (c, s),
every row turns its column pairs with the table; then the ring turns: the
columns by moving registers, the rows of A through the scratch (lane k's
top to lane k+1's top, lane 0's bottom to lane 1's top, bottoms to lane
k-1, lane m-1's top to its own bottom, lane 0's top fixed).  Operands come
from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pythonic_disort_tpu.ops import jacobi as jjac
from pythonic_disort_torch.ops import jacobi


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _variant(n, itemsize=4):
    """The register body's (MP, G, W, NR) at n, as the kernel's launch picks
    it: slots a lane holds, lanes a matrix, warps a matrix, rows a lane."""
    if n <= 16:
        return 8, 8, 1, 4
    if n <= 34:
        return (17, 17, 1, 4) if itemsize == 4 else (17, 32, 2, 2)
    assert itemsize == 4 and n <= 64
    return 32, 32, 2, 2


def _vrow(W, MP, wi, k, a):
    """``Reg::vrow``: the row of V that row a of lane k in warp wi holds,
    -1 for none, -2 for a row of A."""
    if W == 2:
        return -2 if wi == 0 else (k + a * MP if k < MP else -1)
    return -2 if a < 2 else k + (a - 2) * MP


def _rows_at(N, r):
    """The row each position holds in round r: position 0 row 0, position
    x >= 1 row 1 + ((x - 1 - r) mod (N - 1))."""
    x = np.arange(N)
    return np.where(x == 0, 0, 1 + (x - 1 - r) % (N - 1))


def _turn_columns(xt, xb, m):
    """``turn_columns`` on (..., MP) arrays: position x -> x + 1 for
    1 <= x <= N-2, N-1 -> 1, 0 fixed; the padding slots take junk."""
    MP = xt.shape[-1]
    last = xb[..., 0].copy()
    for j in range(MP - 1):
        xb[..., j] = xt[..., j] if j == m - 1 else xb[..., j + 1]
    xb[..., MP - 1] = xt[..., MP - 1]
    for j in range(MP - 1, 1, -1):
        xt[..., j] = xt[..., j - 1]
    xt[..., 1] = last


def _register_model(A, sweeps, itemsize=4):
    """numpy model of the register body on A (B, n, n); returns w (B, n)
    and V (B, n, n), in row order, unsorted.  ``xt``, ``xb`` (B, W, G, NR,
    MP) are the registers of every lane; the first warp's rows 0 and 1 go
    through the shift scratch (B, G, 4, MP) after each round."""
    Bn, n, _ = A.shape
    MP, G, W, NR = _variant(n, itemsize)
    N = n + n % 2
    m, ring = N // 2, N - 1
    Ap = np.zeros((Bn, N, N))
    Ap[:, :n, :n] = A
    j = np.arange(MP)
    xt, xb = np.zeros((Bn, W, G, NR, MP)), np.zeros((Bn, W, G, NR, MP))
    for wi in range(W):
        for k in range(G):
            for a in range(NR):
                v = _vrow(W, MP, wi, k, a)
                if v == -2:
                    r = k if a == 0 else N - 1 - k
                    if k < m and r < n:
                        xt[:, wi, k, a] = np.where(j < m, Ap[:, r, np.minimum(j, N - 1)], 0.0)
                        xb[:, wi, k, a] = np.where(j < m, Ap[:, r, np.clip(N - 1 - j, 0, N - 1)], 0.0)
                else:
                    xt[:, wi, k, a] = v == j
                    xb[:, wi, k, a] = (j < m) & (v == N - 1 - j)
    k = np.arange(G)
    slot = k < m
    # the scratch rows each lane reads after a turn: (lane, row 0 or 1)
    top_lane = np.where(slot & (k >= 1) & (m > 1), np.where(k == 1, 0, k - 1), k)
    top_row = np.where(slot & (k == 1) & (m > 1), 1, 0)
    bot_lane = np.where(slot & (m > 1), np.where(k == m - 1, k, (k + 1) % G), k)
    bot_row = np.where(slot & (m > 1) & (k == m - 1), 0, 1)

    def publish(shift):
        scr = np.stack([xt[:, 0, :, 0], xb[:, 0, :, 0], xt[:, 0, :, 1], xb[:, 0, :, 1]], axis=2)
        if shift:
            xt[:, 0, :, 0], xb[:, 0, :, 0] = scr[:, top_lane, 2 * top_row], scr[:, top_lane, 2 * top_row + 1]
            xt[:, 0, :, 1], xb[:, 0, :, 1] = scr[:, bot_lane, 2 * bot_row], scr[:, bot_lane, 2 * bot_row + 1]
        tl, tr, bl, br = (top_lane, top_row, bot_lane, bot_row) if shift else (k, 0, k, 1)
        kk = np.minimum(k, MP - 1)
        return (scr[:, tl, 2 * tr, kk], scr[:, tl, 2 * tr + 1, kk], scr[:, bl, 2 * br, kk], scr[:, bl, 2 * br + 1, kk])

    dt, ob, ot, db = publish(False)
    for r in range(sweeps * ring):
        off = r % ring
        pt, pb = (k - 1 - off) % ring, (ring - 1 - k - off) % ring
        swap = (k > 0) & (pt > pb)
        # every lane names its rows as the plain schedule does
        if r < ring:
            at = _rows_at(N, off)
            assert (at[k[slot]] == np.where(k[slot] == 0, 0, 1 + pt[slot])).all()
            assert (at[N - 1 - k[slot]] == 1 + pb[slot]).all()
        app, aqq = np.where(swap, db, dt), np.where(swap, dt, db)
        apq = np.where(swap, ot, ob)
        theta = (aqq - app) * 0.5
        denom = np.abs(theta) + np.sqrt(theta * theta + apq * apq)
        sgn = np.where(theta >= 0, 1.0, -1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            t = np.where(np.abs(apq) > 0, sgn * apq / np.where(denom > 0, denom, 1.0), 0.0)
        c = 1.0 / np.sqrt(1.0 + t * t)
        s = t * c
        c, s = np.where(slot, c, 1.0), np.where(slot, np.where(swap, -s, s), 0.0)
        ct, st = c[:, :MP], s[:, :MP]                                            # the (c, s) table
        # the first warp's row pass with its own (c, s)
        cl, sl = c[..., None], s[..., None]
        for x in (xt, xb):
            u, v = x[:, 0, :, 0].copy(), x[:, 0, :, 1].copy()
            x[:, 0, :, 0], x[:, 0, :, 1] = cl * u - sl * v, sl * u + cl * v
        # every row's column pass with the table
        cj, sj = ct[:, None, None, None, :], st[:, None, None, None, :]
        u, v = xt.copy(), xb.copy()
        xt[:], xb[:] = cj * u - sj * v, sj * u + cj * v
        if m > 1:
            _turn_columns(xt, xb, m)
        dt, ob, ot, db = publish(m > 1)
    w = np.zeros((Bn, n))
    V = np.zeros((Bn, n, n))
    for kk in range(m):
        w[:, kk] = dt[:, kk]
        if N - 1 - kk < n:
            w[:, N - 1 - kk] = db[:, kk]
    for wi in range(W):
        for kk in range(G):
            for a in range(NR):
                i = _vrow(W, MP, wi, kk, a)
                if 0 <= i < n:
                    for jj in range(m):
                        V[:, i, jj] = xt[:, wi, kk, a, jj]
                        if N - 1 - jj < n:
                            V[:, i, N - 1 - jj] = xb[:, wi, kk, a, jj]
    return w, V


def _matrices(n, B, seed, tied=False):
    """Symmetric noise on a diagonal ramp; ``tied``: the diagonal holds
    each value twice (odd n: one value once more), so tied pairs turn by
    45 degrees."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    A = (base + np.swapaxes(base, -1, -2)) / 2
    idx = np.arange(n)
    if tied:
        d = np.repeat(np.linspace(1, 4, (n + 1) // 2), 2)[:n]
        A[:, idx, idx] = rng.permuted(np.broadcast_to(d, (B, n)), axis=1)
    else:
        A[:, idx, idx] += np.linspace(1, 4, n)
    return A


def _order_free(A, w, V, w_ref):
    """Sorted w against ``w_ref`` (B, n) ascending, |V^T V - I| and
    |V diag(w) V^T - A|, each the largest over the lanes."""
    eye = np.eye(A.shape[-1])
    return (np.abs(np.sort(w, axis=-1) - w_ref).max(),
            np.abs(np.swapaxes(V, -1, -2) @ V - eye).max(),
            np.abs(V @ (w[..., None] * np.swapaxes(V, -1, -2)) - A).max())


@pytest.mark.parametrize("n,itemsize", [(1, 4), (2, 4), (3, 4), (15, 4), (33, 4), (34, 4), (64, 4), (34, 8)])
@pytest.mark.parametrize("tied", [False, True])
def test_register_order_matches_plain(n, itemsize, tied):
    """The model's eigenpairs within 1e-10 of the plain version in float64
    (sorted w), orthogonal and reconstructing A to 1e-10, at the widths
    the real paths run, an odd n past 32 and the smallest ones, in the
    float32 layouts and the float64 one at n = 34 (two warps)."""
    A = _matrices(n, 3, seed=10 * n + tied, tied=tied)
    sweeps = jacobi.default_sweeps(n, torch.float64)
    w, V = _register_model(A, sweeps, itemsize)
    wp, Vp = jacobi.jacobi_eigh_lanes_plain(torch.as_tensor(np.moveaxis(A, 0, -1)), sweeps)
    wp, Vp = wp.numpy().T, np.moveaxis(Vp.numpy(), -1, 0)
    w_err, orth, recon = _order_free(A, w, V, np.sort(wp, axis=-1))
    assert max(w_err, orth, recon) < 1e-10
    # the same rotations in the same order: the plain version's own pairs
    np.testing.assert_allclose(w, wp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(V, Vp, rtol=0, atol=1e-12)


def test_register_order_matches_jax():
    """At an even n past 32 the model's eigenpairs match the JAX
    package's ``jacobi_eigh(..., sort=True)`` within 1e-10."""
    n = 34
    A = _matrices(n, 2, seed=5)
    w, V = _register_model(A, jacobi.default_sweeps(n, torch.float64))
    wj, _ = jjac.jacobi_eigh(jnp.asarray(A), sort=True)
    w_err, orth, recon = _order_free(A, w, V, np.asarray(wj))
    assert max(w_err, orth, recon) < 1e-10


@pytest.mark.parametrize("N", [2, 4, 16, 34, 64])
def test_ring_turns_as_the_schedule(N):
    """Turning the ring once a round moves every row to the position the
    schedule gives it next, and the slots (k, N-1-k) of each round are the
    pairs of `_round_robin_schedule`; after N-1 rounds the positions hold
    the rows in order again."""
    p, q = jacobi._round_robin_schedule(N)
    for r in range(N - 1):
        at = _rows_at(N, r)
        pairs = {tuple(sorted((at[k], at[N - 1 - k]))) for k in range(N // 2)}
        assert pairs == set(zip(p[r], q[r]))
    np.testing.assert_array_equal(_rows_at(N, N - 1), np.arange(N))
    # the register moves of turn_columns on a row that holds its positions
    MP = max(N // 2, 1) + 1
    m = N // 2
    j = np.arange(MP)
    xt = np.where(j < m, j, -1).astype(float)
    xb = np.where(j < m, N - 1 - j, -1).astype(float)
    if m > 1:
        _turn_columns(xt, xb, m)
        moved = np.empty(N)
        moved[j[:m]] = xt[:m]
        moved[N - 1 - j[:m]] = xb[:m]
        want = np.empty(N)
        want[0] = 0
        x = np.arange(1, N)
        want[1 + x % (N - 1)] = x
        np.testing.assert_array_equal(moved, want)


@pytest.mark.parametrize("n", [15, 34])
def test_register_order_reads_the_upper_triangle(n):
    """The pivot is A[p][q], p < q, as the plain version reads it: on a
    matrix whose lower triangle differs from its upper one the model
    follows the plain version entry for entry."""
    A = _matrices(n, 2, seed=n)
    A = A + np.tril(np.full((n, n), 1e-3), -1)[None]
    sweeps = jacobi.default_sweeps(n, torch.float64)
    w, V = _register_model(A, sweeps)
    wp, Vp = jacobi.jacobi_eigh_lanes_plain(torch.as_tensor(np.moveaxis(A, 0, -1)), sweeps)
    np.testing.assert_allclose(w, wp.numpy().T, rtol=0, atol=1e-12)
    np.testing.assert_allclose(V, np.moveaxis(Vp.numpy(), -1, 0), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [15, 34])
def test_swapped_tied_pair_turns_as_plain(n):
    """A tied pair met with its row q in the slot's top position turns by
    45 degrees in the plain version's direction: a diagonal matrix but for
    one such pair keeps every other rotation the identity, and the pair's
    eigenvalues land on its rows as the plain version puts them."""
    N = n + n % 2
    found = None
    for r in range(1, N - 1):
        at = _rows_at(N, r)
        for k in range(1, N // 2):
            top, bot = at[k], at[N - 1 - k]
            if top > bot and top < n:
                found = bot, top
                break
        if found:
            break
    p, q = found
    A = np.diag(np.linspace(1.0, 4.0, n))[None].copy()
    A[0, p, p] = A[0, q, q] = 2.0
    A[0, p, q] = A[0, q, p] = 0.5
    sweeps = jacobi.default_sweeps(n, torch.float64)
    w, V = _register_model(A, sweeps)
    wp, Vp = jacobi.jacobi_eigh_lanes_plain(torch.as_tensor(np.moveaxis(A, 0, -1)), sweeps)
    np.testing.assert_allclose(w, wp.numpy().T, rtol=0, atol=1e-12)
    np.testing.assert_allclose(V, np.moveaxis(Vp.numpy(), -1, 0), rtol=0, atol=1e-12)
    assert abs(w[0, p] - 1.5) < 1e-12 and abs(w[0, q] - 2.5) < 1e-12
