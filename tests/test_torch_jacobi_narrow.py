"""The order of operations of kernel 4
(``pythonic_disort_torch/csrc/jacobi_eigh.cu``, ``jacobi_eigh_kernel``),
modelled in numpy and held against the JAX package's
``pallas_jacobi.jacobi_sweeps`` (eager, CPU, float64) entry by entry, and
against LAPACK order-free.

The model follows the kernel lane by lane.  Its variant (capacity 16, 24
or 32, MP = capacity / 2 lanes a matrix, FULL where n is the capacity);
the matrix in the schedule's position order (slot k pairs positions k and
n-1-k, position 0 holds row 0, the other n-1 positions a ring that turns
by one a round); lane k holds the rows of A at positions k and n-1-k and
rows k and k + MP of V, each row as two arrays by column slot j; the
lane's rows named in closed form (the tie rule compares them); its (c, s)
from the carried diagonal and the averaged pivot, the cosine rsqrt with
two Newton steps; the row pass with its own (c, s), the column pass with
the table's; V's column turn by moves; A's rows and carried diagonals
written to the lane's region (row 0 at 0, row 1 at 2 MP, the diagonals at
4 MP) and read back turned from the neighbours' regions through the
kernel's addresses; the next pivot, the final diagonal and, at a sweep's
end, the re-symmetrization read from the regions.  Operands come from
numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pythonic_disort_tpu.ops.pallas_jacobi import _partner_perms, jacobi_sweeps
from pythonic_disort_torch.ops import jacobi
from pythonic_disort_torch.tools.check_jacobi import DEFAULT_SWEEP_READINGS, LIMITS, readings


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _variant(n):
    """(MP, FULL): the capacity's lanes a matrix, and whether n fills it."""
    MP = 8 if n <= 16 else 12 if n <= 24 else 16
    return MP, n == 2 * MP


def _rows_at(n, r):
    """The row each position holds in round r: position 0 row 0, position
    x >= 1 row 1 + ((x - 1 - r) mod (n - 1))."""
    x = np.arange(n)
    return np.where(x == 0, 0, 1 + (x - 1 - r) % (n - 1))


def _lane_rows(k, off, n):
    """The kernel's names of the rows at lane k's positions (k, n-1-k), less
    1, at the ring's turn ``off``: (pt, pb)."""
    ring = n - 1
    return (k - 1 - off) % ring, (ring - 1 - k - off) % ring


def _turn_columns(xt, xb, m, full):
    """``turn_columns`` on (..., MP) arrays."""
    MP = xt.shape[-1]
    last = xb[..., 0].copy()
    for j in range(MP - 1):
        xb[..., j] = xt[..., j] if (not full and j == m - 1) else xb[..., j + 1]
    xb[..., MP - 1] = xt[..., MP - 1]
    for j in range(MP - 1, 1, -1):
        xt[..., j] = xt[..., j - 1]
    xt[..., 1] = last


def _turned(ot, ob, m, full):
    """``get_turned``: the old slots of a row land turned."""
    MP = ot.shape[-1]
    xt, xb = np.empty_like(ot), np.empty_like(ob)
    xt[..., 0], xt[..., 1], xt[..., 2:] = ot[..., 0], ob[..., 0], ot[..., 1:MP - 1]
    for j in range(MP - 1):
        xb[..., j] = ot[..., j] if (not full and j == m - 1) else ob[..., j + 1]
    xb[..., MP - 1] = ot[..., MP - 1]
    return xt, xb


def _kernel_model(A, sweeps, itemsize=8):
    """numpy model of kernel 4 on A (B, n, n); returns w (B, n) and V (B, n,
    n), unsorted.  ``xt``, ``xb`` (B, MP, 4, MP): every lane's rows (0, 1 of
    A, 2, 3 of V); ``reg`` (B, MP, LS): the lanes' regions."""
    Bn, n, _ = A.shape
    MP, full = _variant(n)
    VEC = 16 // itemsize
    LS = 4 * MP + VEC
    m, ring = n // 2, n - 1
    turn = full or m > 1
    k = np.arange(MP)
    slot = k < m
    xt, xb = np.zeros((Bn, MP, 4, MP)), np.zeros((Bn, MP, 4, MP))
    cols = np.arange(m)
    for kk in range(m):
        for a, r in ((0, kk), (1, n - 1 - kk)):
            xt[:, kk, a, :m] = A[:, r, cols]
            xb[:, kk, a, :m] = A[:, r, n - 1 - cols]
    j = np.arange(MP)
    for a in (2, 3):
        v = k[:, None] + (a - 2) * MP
        xt[:, :, a] = (j < m) & (v == j)
        xb[:, :, a] = (j < m) & (v == n - 1 - j)
    reg = np.zeros((Bn, MP, LS))

    def put(dt=None, db=None):
        reg[:, :, :MP], reg[:, :, MP:2 * MP] = xt[:, :, 0], xb[:, :, 0]
        reg[:, :, 2 * MP:3 * MP], reg[:, :, 3 * MP:4 * MP] = xt[:, :, 1], xb[:, :, 1]
        if dt is not None:
            reg[:, :, 4 * MP], reg[:, :, 4 * MP + 1] = dt, db

    def at(lane, base, col):
        """Per lane k: reg[lane[k], base[k] + col[k]], (B, MP)."""
        return reg[:, lane, base + col]

    def resymmetrize(turned, ct, cb):
        for jj in range(m):
            if not turned:
                rt, rb = (jj, 0), (jj, 2 * MP)
            else:
                rt = (0, 0) if jj == 0 else (0, 2 * MP) if jj == 1 else (jj - 1, 0)
                rb = (m - 1, 0) if jj == m - 1 else (jj + 1, 2 * MP)
            for a, c_ in ((0, ct), (1, cb)):
                got_t = reg[:, rt[0], rt[1] + c_]
                got_b = reg[:, rb[0], rb[1] + c_]
                xt[:, :, a, jj] = np.where(slot, 0.5 * (xt[:, :, a, jj] + got_t), xt[:, :, a, jj])
                xb[:, :, a, jj] = np.where(slot, 0.5 * (xb[:, :, a, jj] + got_b), xb[:, :, a, jj])

    put()
    kk = np.minimum(k, MP - 1)
    dt, db = reg[:, k, kk], reg[:, k, 3 * MP + kk]
    offd = 0.5 * (reg[:, k, MP + kk] + reg[:, k, 2 * MP + kk])
    wt, wb = dt.copy(), db.copy()
    total = sweeps * ring
    if total > 0:
        resymmetrize(False, k, MP + k)
    # where the rows at each lane's positions were before a turn
    moves = turn & slot
    top_lane = np.where(~moves, k, np.where(k <= 1, 0, k - 1))
    top_row = np.where(moves & (k == 1), 1, 0)
    bot_lane = np.where(~moves | (k == m - 1), k, k + 1)
    bot_row = np.where(moves & (k == m - 1), 0, 1)
    ct = k if not turn else np.where(k == 0, 0, np.where(k == 1, MP, k - 1))
    cb = MP + k if not turn else np.where(k == m - 1, m - 1, MP + k + 1)
    top_base, bot_base = top_row * 2 * MP, bot_row * 2 * MP
    off = 0
    for r in range(total):
        pt, pb = _lane_rows(k, off, n)
        lower = (k == 0) | (pt < pb)
        theta = (db - dt) * 0.5
        denom = np.abs(theta) + np.sqrt(theta * theta + offd * offd)
        sgn = np.where(theta > 0, 1.0, np.where(theta < 0, -1.0, np.where(lower, 1.0, -1.0)))
        with np.errstate(invalid="ignore", divide="ignore"):
            tt = np.where(np.abs(offd) > 0, sgn * offd / np.where(denom > 0, denom, 1.0), 0.0)
        x = 1.0 + tt * tt
        c = 1.0 / np.sqrt(x)
        c = c * (1.5 - 0.5 * x * c * c)
        c = c * (1.5 - 0.5 * x * c * c)
        s = tt * c
        dt, db = np.where(slot, dt - tt * offd, dt), np.where(slot, db + tt * offd, db)
        c, s = np.where(slot, c, 1.0), np.where(slot, s, 0.0)
        # the row pass with the lane's own (c, s)
        cl, sl = c[..., None], s[..., None]
        for arr in (xt, xb):
            u, v = arr[:, :, 0].copy(), arr[:, :, 1].copy()
            arr[:, :, 0], arr[:, :, 1] = cl * u - sl * v, sl * u + cl * v
        # the column pass with the table's
        cj, sj = c[:, None, None, :], s[:, None, None, :]
        u, v = xt.copy(), xb.copy()
        xt[:], xb[:] = cj * u - sj * v, sj * u + cj * v
        if turn:
            _turn_columns(xt[:, :, 2:], xb[:, :, 2:], m, full)
        put(dt, db)
        for a, lane, base in ((0, top_lane, top_base), (1, bot_lane, bot_base)):
            ot = reg[:, lane[:, None], base[:, None] + j[None]]
            ob = reg[:, lane[:, None], base[:, None] + MP + j[None]]
            xt[:, :, a], xb[:, :, a] = _turned(ot, ob, m, full) if turn else (ot, ob)
        dt = np.where(slot, reg[:, top_lane, 4 * MP + top_row], dt)
        db = np.where(slot, reg[:, bot_lane, 4 * MP + bot_row], db)
        offd = 0.5 * (at(top_lane, top_base, cb) + at(bot_lane, bot_base, ct))
        if off == ring - 1 and r + 1 < total:
            resymmetrize(turn, ct, cb)
        off = 0 if off + 1 == ring else off + 1
    if total > 0:
        wt, wb = at(top_lane, top_base, ct), at(bot_lane, bot_base, cb)
    w = np.zeros((Bn, n))
    V = np.zeros((Bn, n, n))
    for kk in range(m):
        w[:, kk], w[:, n - 1 - kk] = wt[:, kk], wb[:, kk]
    for kk in range(MP):
        for a in (2, 3):
            i = kk + (a - 2) * MP
            if i < n:
                V[:, i, cols] = xt[:, kk, a, :m]
                V[:, i, n - 1 - cols] = xb[:, kk, a, :m]
    return w, V


def _ramp(n, B, seed):
    """Symmetric noise of scale 0.1 on a diagonal ramp from 1 to 4."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    return (base + np.swapaxes(base, -1, -2)) / 2 + np.eye(n) * np.linspace(1, 4, n)


def _tied(n, B, seed):
    """The diagonal holds each of n/2 values twice, in a random order per
    lane (`tools.check_jacobi.tied_matrices`)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    A = (base + np.swapaxes(base, -1, -2)) / 2
    idx = np.arange(n)
    A[:, idx, idx] = rng.permuted(np.broadcast_to(np.repeat(np.linspace(1, 4, n // 2), 2), (B, n)), axis=1)
    return A


def _constant_diagonal(n, B, seed):
    """Every diagonal entry 2: every pair of the first sweep ties."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.3
    A = (base + np.swapaxes(base, -1, -2)) / 2
    A[:, np.arange(n), np.arange(n)] = 2.0
    return A


def _lanes(x):
    return torch.as_tensor(np.moveaxis(x, 0, -1))


@pytest.mark.parametrize("n", [2, 4, 16, 24, 32])
def test_model_matches_jax_sweeps(n):
    """The model against ``jacobi_sweeps`` (eager) on the same untied
    matrices in float64 at 9 sweeps: the same schedule, pivots, carried
    diagonal and re-symmetrization, so w (the final diagonal) and V^T agree
    entry by entry within 1e-10.  n = 2 and 4 run a variant that does not
    fill its capacity."""
    A = _ramp(n, 2, seed=100 + n)
    sweeps = jacobi.default_sweeps(n, torch.float64)
    w, V = _kernel_model(A, sweeps)
    with jax.disable_jit():
        a, wv = jacobi_sweeps(jnp.asarray(np.moveaxis(A, 0, -1)), n=n, sweeps=sweeps, perms=_partner_perms(n))
    w_ref = np.diagonal(np.asarray(a), axis1=0, axis2=1)                         # (B, n)
    Vt_ref = np.moveaxis(np.asarray(wv), -1, 0)                                  # (B, n, n) = V^T
    np.testing.assert_allclose(w, w_ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.swapaxes(V, -1, -2), Vt_ref, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [16, 24])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_model_matches_jax_on_asymmetric_input(n, sweeps):
    """On an input whose lower triangle exceeds the upper by 1e-3, one or
    two sweeps (not yet converged, so every angle shows): the first round's
    pivot is the average of both triangles, read before the first
    re-symmetrization, as ``jacobi_sweeps`` reads it after."""
    A = _ramp(n, 2, seed=200 + n) + np.tril(np.full((n, n), 1e-3), -1)[None]
    w, V = _kernel_model(A, sweeps)
    with jax.disable_jit():
        a, wv = jacobi_sweeps(jnp.asarray(np.moveaxis(A, 0, -1)), n=n, sweeps=sweeps, perms=_partner_perms(n))
    np.testing.assert_allclose(w, np.diagonal(np.asarray(a), axis1=0, axis2=1), rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.swapaxes(V, -1, -2), np.moveaxis(np.asarray(wv), -1, 0), rtol=0, atol=1e-10)


def test_model_layout_of_float32():
    """The regions of the float32 build (16-byte vectors of four) give the
    same results as those of the float64 build: the addresses follow the
    layout."""
    A = _ramp(24, 2, seed=7)
    w4, V4 = _kernel_model(A, 9, itemsize=4)
    w8, V8 = _kernel_model(A, 9, itemsize=8)
    np.testing.assert_array_equal(w4, w8)
    np.testing.assert_array_equal(V4, V8)


@pytest.mark.parametrize("n", [2, 4, 10, 16, 22, 24, 30, 32])
@pytest.mark.parametrize("make", [_tied, _constant_diagonal], ids=["tied pairs", "constant diagonal"])
def test_model_order_free_on_ties(n, make):
    """Order-free against LAPACK (`tools.check_jacobi.readings`) at its
    float64 limits on batches whose pairs tie exactly: in pairs, and every
    pair of the first sweep (the constant diagonal: held on w and
    orthogonality at the default sweep count, on every reading one sweep
    later, as `chip_smoke.py` holds the kernel)."""
    A = make(n, 6, seed=n)
    At = _lanes(A)
    sweeps = jacobi.default_sweeps(n, torch.float64)
    dense = make is _constant_diagonal
    for more, keys in ((0, DEFAULT_SWEEP_READINGS if dense else tuple(LIMITS[torch.float64])),
                       (1, tuple(LIMITS[torch.float64])))[:2 if dense else 1]:
        w, V = _kernel_model(A, sweeps + more)
        r = readings(At, torch.as_tensor(w.T.copy()), _lanes(V))
        bad = {key: r[key] for key in keys if not r[key] < LIMITS[torch.float64][key]}
        assert not bad, (more, bad)


@pytest.mark.parametrize("n", [2, 4, 16, 24, 32])
def test_lane_rows_follow_the_schedule(n):
    """The rows the kernel names at each lane's positions from the ring's
    turn are the positions' rows, and the slots (k, n-1-k) of each round
    are the pairs of `_round_robin_schedule`; the ring is back in row order
    after n-1 rounds."""
    p, q = jacobi._round_robin_schedule(n)
    k = np.arange(n // 2)
    for r in range(n - 1):
        at = _rows_at(n, r)
        pt, pb = _lane_rows(k, r, n)
        np.testing.assert_array_equal(at[k], np.where(k == 0, 0, 1 + pt))
        np.testing.assert_array_equal(at[n - 1 - k], 1 + pb)
        assert {tuple(sorted((at[s], at[n - 1 - s]))) for s in k} == set(zip(p[r], q[r]))
    np.testing.assert_array_equal(_rows_at(n, n - 1), np.arange(n))


@pytest.mark.parametrize("n", [16, 24])
def test_swapped_tied_pair_turns_as_plain(n):
    """A tied pair met with its higher row in the slot's top position turns
    by 45 degrees with the lower row taking +, as the plain version turns
    it: on a diagonal matrix but for that pair every other rotation is the
    identity, and the pair's eigenvalues land on its rows as the plain
    version puts them."""
    found = None
    for r in range(1, n - 1):
        at = _rows_at(n, r)
        for s in range(1, n // 2):
            if at[s] > at[n - 1 - s]:
                found = at[n - 1 - s], at[s]
                break
        if found:
            break
    p, q = found
    A = np.diag(np.linspace(1.0, 4.0, n))[None].copy()
    A[0, p, p] = A[0, q, q] = 2.0
    A[0, p, q] = A[0, q, p] = 0.5
    sweeps = jacobi.default_sweeps(n, torch.float64)
    w, V = _kernel_model(A, sweeps)
    wp, Vp = jacobi.jacobi_eigh_lanes_plain(_lanes(A), sweeps)
    np.testing.assert_allclose(w, wp.numpy().T, rtol=0, atol=1e-12)
    np.testing.assert_allclose(V, np.moveaxis(Vp.numpy(), -1, 0), rtol=0, atol=1e-12)
    assert abs(w[0, p] - 1.5) < 1e-12 and abs(w[0, q] - 2.5) < 1e-12


def test_no_sweeps_returns_the_diagonal():
    """Zero sweeps: w is A's diagonal and V the identity, as the kernel
    stores them without a round."""
    A = _ramp(16, 2, seed=3)
    w, V = _kernel_model(A, 0)
    np.testing.assert_array_equal(w, np.diagonal(A, axis1=1, axis2=2))
    np.testing.assert_array_equal(V, np.broadcast_to(np.eye(16), V.shape))
