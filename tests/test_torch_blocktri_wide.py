"""The order of operations of kernel 6's register tile
(``pythonic_disort_torch/csrc/blocktri_wide.cu``, ``blocktri_wide_tile_kernel``),
modelled in numpy and held against the port's plain block Thomas
(``ops/blocktri.py::solve_block_tridiag_lanes``) and the JAX package's
jnp block Thomas (CPU, float64).

The model follows the kernel's order and layout: the correction is the
product ``P = Low [W | g]`` of the layer before, summed over k in order,
and then ``[dhat | rhat] = [D | r] - P``; each thread holds RPT rows of
one column in registers, TR = 2 threads a column; a step's pivot column
goes to shared memory at ``at(i)``, padded to 16 bytes a thread, and is
searched by the warp that holds it, each lane over rows ``lane + 32 s``:
the largest key of each s (a redux; two for a 64-bit key), the lowest s
that holds the overall largest, and in it the lowest lane (a ballot), so
that a tie keeps the lowest row; the multipliers of every row but the
pivot row are taken with one reciprocal into the step's parity slot, and
only the columns right of k (every U column, and rhat) are updated, each
with the pivot row's entry picked by a select tree in the thread that
holds it; rows never move and are scaled when [W | g] is written back in
the order of the unknowns.  Operands come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pythonic_disort_tpu.ops import blocktri as jbt
from pythonic_disort_torch.ops import blocktri


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _variant(n, itemsize):
    """The register tile's (TR, RPT) at n, as the kernel's launch picks
    it, and VEC, the entries of 16 bytes."""
    if n <= 68:
        return 2, 34, 16 // itemsize
    assert itemsize == 4 and n <= 128
    return 2, 64, 4


def _pick(a, m):
    """The kernel's ``pick``: a[..., m] by a select tree over groups of
    eight entries, then over the groups, with m only in the conditions."""
    N = a.shape[-1]
    G = (N + 7) // 8
    lo, hi = m & 7, m >> 3
    g = []
    for q in range(G):
        v = [a[..., 8 * q + u] if 8 * q + u < N else np.zeros(a.shape[:-1]) for u in range(8)]
        w = 1
        while w < 8:
            for u in range(0, 8 - w, 2 * w):
                v[u] = v[u + w] if lo & w else v[u]
            w <<= 1
        g.append(v[0])
    w = 1
    while w < G:
        for q in range(0, G - w, 2 * w):
            g[q] = g[q + w] if hi & w else g[q]
        w <<= 1
    return g[0]


def _key(x, used):
    """``pivot_key``: the bits of |x| plus 1, 0 for a row that has pivoted."""
    return np.where(used, np.uint64(0), np.abs(x).view(np.uint64) + np.uint64(1))


def _warp_max(keys, wide):
    """``warp_max`` over the 32 lanes: one redux, or for a 64-bit key two,
    the high words, then the low words of the lanes that hold the top high
    word."""
    if not wide:
        return keys.max()
    hi, lo = keys >> np.uint64(32), keys & np.uint64(0xFFFFFFFF)
    mh = hi.max()
    return (mh << np.uint64(32)) | np.where(hi == mh, lo, np.uint64(0)).max()


def _pivot_search(sC, at, used, n, cap, wide):
    """The owner warp's search over the pivot column as it lies in shared
    memory: lane over rows lane + 32 s (``used`` (32, S), set for rows past
    n), a redux per s, the lowest s that holds the largest key, and in it
    the lowest lane of the ballot.  Returns the pivot row and its value."""
    S = used.shape[1]
    lanes = np.arange(32)
    v = np.zeros((32, S))
    for s in range(S):
        rows = lanes + 32 * s
        v[rows < cap, s] = sC[[at(i) for i in rows[rows < cap]]]
    top = [_warp_max(_key(v[:, s], used[:, s]), wide) for s in range(S)]
    best = max(top)
    sel = top.index(best)
    src = int(np.flatnonzero(_key(v[:, sel], used[:, sel]) == best)[0])
    return 32 * sel + src, v[src, sel]


def _pivot(col, used):
    """The pivot of one column with the n <= 68 layout (see
    `_pivot_search`)."""
    n = len(col)
    _, RPT, VEC = _variant(n, 4)
    RPTP = -(-RPT // VEC) * VEC
    at = lambda i: i // RPT * RPTP + i % RPT
    sC = np.zeros(2 * RPTP)
    for i in range(n):
        sC[at(i)] = col[i]
    rows = np.arange(32)[:, None] + 32 * np.arange(3)[None, :]
    u = np.ones((32, 3), bool)
    u[rows < n] = used[rows[rows < n]]
    return _pivot_search(sC, at, u, n, 2 * RPT, False)[0]


def _tile_model(lower, diag, upper, rhs, itemsize=4):
    """numpy model of the register tile, one lane at a time, in the
    kernel's layout: ``a[c, r, m]`` is the register m of the thread that
    holds column c, rows r RPT + m (rhat a column at RPT = 34, a vector in
    shared memory at 64); the pivot column and the multipliers of the
    steps' two parity slots sit at ``at(i)`` in TR x RPTP slots, padded to
    16 bytes; the pivot row's entry of a column comes from the thread that
    holds it (``_pick``, then the shuffle).  ``itemsize`` sets VEC and so
    the padding.  Returns x (L, n, B) and the unknown each row pivoted
    for, (L, n, B)."""
    L, n, _, B = diag.shape
    TR, RPT, VEC = _variant(n, itemsize)
    CAP, RPTP = TR * RPT, -(-RPT // VEC) * VEC
    FSZ, S, HV = TR * RPTP, -(-CAP // 32), CAP > 68
    ncol = 2 * n + (0 if HV else 1)
    at = lambda i: i // RPT * RPTP + i % RPT
    pad = lambda m: np.pad(m, [(0, CAP - m.shape[0])] + [(0, 0)] * (m.ndim - 1))
    x = np.empty((L, n, B))
    var_all = np.empty((L, n, B), int)
    for b in range(B):
        stack = []
        sW = np.zeros((CAP, n + 1))                # the [W | g] tile, rows in unknown order
        for l in range(L):
            last = l == L - 1
            a = np.zeros((ncol, CAP))
            a[:n] = pad(diag[l, :, :, b]).T
            if not last:
                a[n:2 * n] = pad(upper[l, :, :, b]).T
            r = pad(rhs[l, :, b])
            if l > 0:
                P = np.zeros((CAP, n + 1))
                for k in range(n):
                    P += np.outer(pad(lower[l, :, k, b]), sW[k])
                a[:n] -= P[:, :n].T
                r = r - P[:, n]
            if HV:
                sH = r.copy()
            else:
                a[2 * n] = r
            a = a.reshape(ncol, TR, RPT)
            rows = np.arange(32)[:, None] + 32 * np.arange(S)[None, :]
            used = rows >= n
            slots = np.full((2, FSZ), np.nan)
            slots[:, [at(i) for i in range(n, CAP)]] = 0.0
            var, rcp = np.full(CAP, -1), np.ones(CAP)
            live = np.zeros(ncol, bool)
            live[n:2 * n] = not last
            if not HV:
                live[2 * n] = True
            for k in range(n):
                f = slots[k & 1]
                sC = np.zeros(FSZ)
                for rr in range(TR):
                    sC[rr * RPTP:rr * RPTP + RPT] = a[k, rr]
                pr, vp = _pivot_search(sC, at, used, n, CAP, itemsize == 8)
                rpv = 1.0 / vp
                hp = sH[pr] if HV else 0.0
                for i in range(n):
                    fm = 0.0 if i == pr else sC[at(i)] * rpv
                    f[at(i)] = fm
                    if HV:
                        sH[i] -= fm * hp
                var[pr], rcp[pr] = k, rpv
                used[pr & 31, pr >> 5] = True
                cols = live.copy()
                cols[k + 1:n] = True
                src = pr // RPT                    # the shuffle's source thread of each column
                p = _pick(a[cols, src], pr - src * RPT)
                fr = np.stack([f[rr * RPTP:rr * RPTP + RPT] for rr in range(TR)])
                a[cols] -= fr[None] * p[:, None, None]
            a = a.reshape(ncol, CAP)
            for i in range(n):
                if not last:
                    sW[var[i], :n] = a[n:2 * n, i] * rcp[i]
                sW[var[i], n] = (sH[i] if HV else a[2 * n, i]) * rcp[i]
            stack.append(sW[:n].copy())
            var_all[l, :, b] = var[:n]
        x[L - 1, :, b] = stack[-1][:, n]
        for l in range(L - 2, -1, -1):
            x[l, :, b] = stack[l][:, n] - stack[l][:, :n] @ x[l + 1, :, b]
    return x, var_all


def _blocks(L, n, B, seed, tie=False):
    """Dense blocks with a dominant diagonal, the rows of every block row
    permuted so that the elimination pivots off the diagonal, NaN in the
    two ignored edge blocks.  ``tie``: column 0 of D_0 holds its largest
    |entry| at rows 3 and 6 (slot 0) and 37 (slot 1), with signs that
    differ."""
    rng = np.random.default_rng(seed)
    lower, upper = (0.5 * rng.standard_normal((L, n, n, B)) / np.sqrt(n) for _ in range(2))
    diag = 3 * np.eye(n)[None, :, :, None] + rng.standard_normal((L, n, n, B)) / np.sqrt(n)
    rhs = rng.standard_normal((L, n, B))
    perm = rng.permutation(n)
    lower, diag, upper, rhs = lower[:, perm], diag[:, perm], upper[:, perm], rhs[:, perm]
    if tie:
        diag[0, :, 0] = np.clip(diag[0, :, 0], -1.0, 1.0)
        diag[0, [37, 6, 3], 0] = np.array([5.0, -5.0, 5.0])[:, None]
    lower[0], upper[-1] = np.nan, np.nan
    return lower, diag, upper, rhs


@pytest.mark.parametrize("n,tie", [(66, False), (68, False), (68, True), (128, False)])
def test_register_tile_order_matches_plain_and_jax(n, tie):
    """x of the model within rtol 1e-10 of the plain version and of the
    JAX package (float64, NaN edge blocks); the elimination pivots off the
    diagonal; a tied pivot column takes its lowest row."""
    ops = _blocks(3, n, 2, seed=n + tie, tie=tie)
    x, var = _tile_model(*ops)
    clean = [np.nan_to_num(o, nan=0.0) for o in ops]
    ref = blocktri.solve_block_tridiag_lanes(*(torch.as_tensor(o) for o in clean)).numpy()
    jref = np.asarray(jbt.solve_block_tridiag_lanes(*(jnp.asarray(o) for o in clean)))
    assert np.isfinite(x).all()
    for want in (ref, jref):
        np.testing.assert_allclose(x, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
    assert (var != np.arange(n)[None, :, None]).any()
    if tie:
        assert (var[0, 3] == 0).all() and (var[0, [6, 37]] != 0).all()


@pytest.mark.parametrize("n", [67, 68])
def test_register_tile_float64_layout_matches_plain_and_jax(n):
    """The float64 variant's layout (two entries in 16 bytes, so RPTP =
    RPT, and a 64-bit key found by two reduxes) at an odd n and at 68:
    x within rtol 1e-10 of the plain version and of the JAX package."""
    ops = _blocks(3, n, 2, seed=7 * n)
    x, _ = _tile_model(*ops, itemsize=8)
    clean = [np.nan_to_num(o, nan=0.0) for o in ops]
    ref = blocktri.solve_block_tridiag_lanes(*(torch.as_tensor(o) for o in clean)).numpy()
    jref = np.asarray(jbt.solve_block_tridiag_lanes(*(jnp.asarray(o) for o in clean)))
    for want in (ref, jref):
        np.testing.assert_allclose(x, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("N", [34, 64])
def test_pick_select_tree(N):
    """``pick`` returns a[m] at every m of the register array, and the
    shuffle's source thread (row // RPT) holds row at pick index row % RPT."""
    a = np.arange(2 * N, dtype=float).reshape(2, N) + 1.0
    for m in range(N):
        np.testing.assert_array_equal(_pick(a, m), a[:, m])
    for row in range(2 * N):
        src = row // N
        assert _pick(a[src], row - src * N) == row + 1.0


def test_pivot_scan_breaks_ties_by_row():
    """The slots and the lanes: among equal |entries| the lowest unused
    row wins, wherever the rows lie."""
    col = np.zeros(68)
    used = np.zeros(68, bool)
    for rows, want in (([40, 7, 5], 5), ([67, 34], 34), ([33, 35], 33), ([1, 2, 3, 4], 1)):
        c = col.copy()
        c[rows] = [(-1.0) ** i * 2.0 for i in range(len(rows))]
        assert _pivot(c, used) == want
    used[[5, 1]] = True
    c = col.copy()
    c[[1, 5, 9, 60]] = 3.0
    assert _pivot(c, used) == 9
