"""The order of operations of kernel 3
(``pythonic_disort_torch/csrc/blocktri.cu``, ``blocktri_kernel``), modelled
in numpy and held against the port's plain block Thomas
(``ops/blocktri.py::solve_block_tridiag_lanes``) and the JAX package's jnp
block Thomas (``ops/blocktri.py::_blocktri_lanes_impl``) in float64 on the
CPU.

The model follows the kernel's layout and order: the variant (capacity N,
CS column groups) that the launch picks at n; thread (i, c) holds row i,
and of it the columns j = m CS + c of dhat and of U (slots m < N / CS) and
rhat, zero outside n; the warps of a lane hold 32 / CS rows each; the
correction ``[dhat | rhat] -= Low [W | g]`` of the layer before, summed in
k order over k < n rounded up to 16 bytes of entries (the tiles are zero
past n); at step k each warp's candidate is the largest key of column k
among its rows (a redux, two for a 64-bit key) and, in it, the lowest lane
of the ballot, whatever row that is when every key is 0; the best of the
warps' candidates is the first with the largest key, so that a tie keeps
the lowest row; one reciprocal of the pivot, the multipliers of every row
but the pivot row, and the update of the slots m >= (k + 1) / CS, of U
unless the layer is the last, and of rhat; rows never move and are scaled
when [W | g] is written back in the order of the unknowns; the back
substitution sums its dot products in j order.  Operands come from numpy
with a seed.
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
    """The kernel's (N, CS, VEC) at n: the capacity, the column groups a
    row and the entries of 16 bytes, as ``dispatch`` picks them."""
    N = next(cap for cap in (16, 32, 48, 64) if n <= cap)
    return N, 1 if N == 32 and itemsize == 4 else 2, 16 // itemsize


def _key(x, used):
    """``pivot_key``: the bits of |x| plus 1, 0 for a row that has pivoted
    (or holds no key)."""
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


def _pivot(col, used, ck, CS, wide):
    """The pivot row of a step: ``col`` and ``used`` per row (N of them),
    the key held by the thread of column group ``ck`` of each row; each
    warp's candidate (its largest key, the lowest lane that holds it), then
    the first warp with the largest key."""
    N = len(col)
    rpw = 32 // CS
    best_key, best_row = None, None
    for w in range(N // rpw):
        rows = np.arange(w * rpw, (w + 1) * rpw)
        keys = np.zeros(32, np.uint64)
        keys[(rows - w * rpw) * CS + ck] = _key(col[rows], used[rows])
        top = _warp_max(keys, wide)
        row = w * rpw + int(np.flatnonzero(keys == top)[0]) // CS
        if best_key is None or top > best_key:
            best_key, best_row = top, row
    return best_row


def _kernel_model(lower, diag, upper, rhs, itemsize=8):
    """numpy model of kernel 3, one lane at a time (see the module
    docstring).  ``itemsize`` picks the variant and its 16-byte width.
    Returns x (L, n, B) and the unknown each row pivoted for, (L, n, B)."""
    L, n, _, B = diag.shape
    N, CS, VEC = _variant(n, itemsize)
    SD = N // CS
    cols = (np.arange(SD)[None, :] * CS + np.arange(CS)[:, None])     # (CS, SD): the column of slot m of group c
    kpad = -(-n // VEC) * VEC
    pad = lambda m: np.pad(m, [(0, N - s) for s in m.shape])
    x = np.empty((L, n, B))
    var_all = np.empty((L, n, B), int)
    for b in range(B):
        stack = []
        tile = np.zeros((N, N + 1))              # [W | g] by unknown; g in column N
        for l in range(L):
            last = l == L - 1
            a = np.zeros((N, CS, 2 * SD + 1))
            a[:, :, :SD] = pad(diag[l, :, :, b])[:, cols]
            if not last:
                a[:, :, SD:2 * SD] = pad(upper[l, :, :, b])[:, cols]
            a[:, :, 2 * SD] = pad(rhs[l, :, b])[:, None]
            if l > 0:
                low = pad(lower[l, :, :, b])
                for k in range(kpad):
                    a[:, :, :SD] -= low[:, k, None, None] * tile[k, cols][None]
                    a[:, :, 2 * SD] -= low[:, k, None] * tile[k, N]
            used = np.arange(N) >= n
            var, rcp = np.full(N, -1), np.ones(N)
            for k in range(n):
                ck, mk, mf = k % CS, k // CS, (k + 1) // CS
                pr = _pivot(a[:, ck, mk], used, ck, CS, itemsize == 8)
                p = a[pr].copy()
                rpv = 1.0 / p[ck, mk]
                f = np.where(np.arange(N) == pr, 0.0, a[:, ck, mk] * rpv)
                a[:, :, mf:SD] -= f[:, None, None] * p[None, :, mf:SD]
                if not last:
                    a[:, :, SD:2 * SD] -= f[:, None, None] * p[None, :, SD:2 * SD]
                a[:, :, 2 * SD] -= f[:, None] * p[None, :, 2 * SD]
                used[pr], var[pr], rcp[pr] = True, k, rpv
            for i in range(n):
                if not last:
                    tile[var[i], cols] = a[i, :, SD:2 * SD] * rcp[i]
                tile[var[i], N] = a[i, 0, 2 * SD] * rcp[i]
            stack.append((tile[:n, :n].copy(), tile[:n, N].copy()))
            var_all[l, :, b] = var[:n]
        x[L - 1, :, b] = stack[-1][1]
        for l in range(L - 2, -1, -1):
            W, g = stack[l]
            acc = g.copy()
            for j in range(n):
                acc -= W[:, j] * x[l + 1, j, b]
            x[l, :, b] = acc
    return x, var_all


def _blocks(L, n, B, seed, ties=()):
    """Dense blocks with a dominant diagonal, the rows of every block row
    permuted so that the elimination pivots off the diagonal, NaN in the
    two ignored edge blocks.  ``ties``: rows of column 0 of D_0 (lane 0)
    that share its largest |entry|, with signs that alternate; the rest of
    the column is cut to |entry| <= 1."""
    rng = np.random.default_rng(seed)
    lower, upper = (0.5 * rng.standard_normal((L, n, n, B)) / np.sqrt(n) for _ in range(2))
    diag = 3 * np.eye(n)[None, :, :, None] + rng.standard_normal((L, n, n, B)) / np.sqrt(n)
    rhs = rng.standard_normal((L, n, B))
    perm = rng.permutation(n)
    lower, diag, upper, rhs = lower[:, perm], diag[:, perm], upper[:, perm], rhs[:, perm]
    if ties:
        diag[0, :, 0, 0] = np.clip(diag[0, :, 0, 0], -1.0, 1.0)
        diag[0, list(ties), 0, 0] = 5.0 * (-1.0) ** np.arange(len(ties))
    lower[0], upper[-1] = np.nan, np.nan
    return lower, diag, upper, rhs


def _references(ops):
    clean = [np.nan_to_num(o, nan=0.0) for o in ops]
    plain = blocktri.solve_block_tridiag_lanes(*(torch.as_tensor(o) for o in clean)).numpy()
    jax_x = np.asarray(jbt._blocktri_lanes_impl(*(jnp.asarray(o) for o in clean)))
    return plain, jax_x


@pytest.mark.parametrize("L,n,B,itemsize", [(1, 2, 3, 4), (3, 7, 2, 8), (6, 16, 2, 4), (2, 24, 2, 8),
                                            (4, 32, 2, 4), (3, 32, 2, 8), (3, 48, 2, 4), (2, 48, 1, 8)])
def test_kernel_order_matches_plain_and_jax(L, n, B, itemsize):
    """x of the model within 1e-12 of the plain version and of the JAX
    package (float64, NaN edge blocks), in the layout of the float32
    (itemsize 4) or the float64 variant; the elimination pivots off the
    diagonal."""
    ops = _blocks(L, n, B, seed=10 * L + n + itemsize)
    x, var = _kernel_model(*ops, itemsize=itemsize)
    assert np.isfinite(x).all()
    for want in _references(ops):
        np.testing.assert_allclose(x, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    if n > 2:
        assert (var != np.arange(n)[None, :, None]).any()


@pytest.mark.parametrize("n,ties,winner,itemsize", [(48, (40, 20, 5), 5, 4), (48, (9, 3), 3, 8),
                                                    (32, (30, 7), 7, 4), (32, (17, 12), 12, 8),
                                                    (7, (6, 4, 2), 2, 4)])
def test_tied_pivots_take_the_lowest_row(n, ties, winner, itemsize):
    """Column 0 of D_0 holds its largest |entry| at several rows, in one
    warp or in different warps: the lowest row pivots for unknown 0, and x
    still matches the plain version and the JAX package to 1e-12."""
    ops = _blocks(3, n, 2, seed=n + winner, ties=ties)
    x, var = _kernel_model(*ops, itemsize=itemsize)
    assert var[0, winner, 0] == 0 and all(var[0, r, 0] != 0 for r in ties if r != winner)
    for want in _references(ops):
        np.testing.assert_allclose(x, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n,itemsize", [(1, 4), (16, 8), (17, 4), (32, 4), (32, 8), (33, 8), (48, 4), (64, 8)])
def test_thread_map_covers_every_row_and_column_once(n, itemsize):
    """The variant at n holds n rows over whole warps and, per row, every
    column of dhat and U once across its CS threads' slots."""
    N, CS, VEC = _variant(n, itemsize)
    assert n <= N and N * CS % 32 == 0 and (N // CS) % VEC == 0
    cols = np.arange(N // CS)[None, :] * CS + np.arange(CS)[:, None]
    assert sorted(cols.ravel()) == list(range(N))
    assert (itemsize == 4 and N == 32) == (CS == 1)


def test_pivot_scan_keys_and_ties():
    """The per-warp scan with 32- and 64-bit keys: the largest |entry| of
    the unused rows, the lowest row on a tie, whichever warp holds it."""
    N, CS = 64, 2
    col = np.zeros(N)
    used = np.zeros(N, bool)
    for rows, want in (([40, 7, 5], 5), ([63, 33], 33), ([31, 32], 31), ([1, 2, 3], 1)):
        c = col.copy()
        c[rows] = [(-1.0) ** k * 2.0 for k in range(len(rows))]
        for wide in (False, True):
            assert _pivot(c, used, 0, CS, wide) == want
    used[[5, 1]] = True
    c = col.copy()
    c[[1, 5, 9, 60]] = 3.0
    assert _pivot(c, used, 1, CS, True) == 9
    # 64-bit keys that differ in the low word alone
    c = np.zeros(N)
    c[20], c[50] = 1.0, np.nextafter(1.0, 2.0)
    assert _pivot(c, np.zeros(N, bool), 0, CS, True) == 50
