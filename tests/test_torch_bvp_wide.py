"""The fused boundary-value solve at every even 2N <= 64 (kernel 7,
``pythonic_disort_torch/csrc/bvp_fused_wide.cu``) held against the JAX
package in float64 on the CPU.

`_kernel_model` follows the kernel's order of operations in numpy, one
lane at a time: the variant (capacity NC = 16, 32, 48 or 64, the
smallest that holds 2N) that the launch picks; the rows of dhat and the
columns past 2N padded with an
identity built in the kernel; D_l assembled from G_l, the decays and
layer 0's sign (bt_rows on the last layer), the [0; I_N] columns set in
place; the correction ``dhat[:N] += C_l Mbot_l[:N]`` summed in k order
from ``C_l = Mtop_{l-1}[N:] [H_{l-1} | g_{l-1}]``, itself summed in k
order after layer l-1's elimination; NC unrolled steps, each warp of 16
rows (two column groups a row) offering the lowest row that holds its
largest key and the first warp with the largest key winning; one
reciprocal a step, the multipliers of every row but the pivot row, rows
never moved and scaled when [H | g] is written in the order of the
unknowns (the padded rows pivot for the padded unknowns and are not
written); the last layer over [dhat | rhat]; the back substitution
``x_l = g_l + H_l (Mbot_{l+1}[:N] x_{l+1})``, each entry of the inner
product summed as four parts (every fourth column) added pairwise and each
of the outer as two (the even and the odd unknowns).
It is held to JAX's ``assemble_bvp_blocks`` + ``solve_block_tridiag_lanes``
within rtol 1e-10, as the port's CPU path (`solve_bvp_fused`, the plain
version on CPU tensors) is.  Operands come from numpy with a seed.  The
batched solve's routing at NQuad = 48 and 68 and its gradient at
NQuad = 48 close the file.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pythonic_disort_tpu import parallel as jpar
from pythonic_disort_tpu.ops import blocktri as jbt

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import batch_solve
from pythonic_disort_torch.ops import cuda_blocktri
from pythonic_disort_torch.tools.check_bvp import bench_arrays
from pythonic_disort_torch.utils import profiling
from test_batch_solve import _problem
from test_torch_solve_fluxes import to_port

CS = 2                   # column groups a row
ROWS_PER_WARP = 32 // CS


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _operands(L, N, B, seed):
    """G = I + a dense random part, decays in (0.05, 0.95), boundary rows
    I + noise, Gaussian right-hand sides (``tests/test_torch_blocktri.py``'s
    kind)."""
    rng = np.random.default_rng(seed)
    n2 = 2 * N
    Gt = np.eye(n2)[None, :, :, None] + 0.3 * rng.standard_normal((L, n2, n2, B)) / np.sqrt(n2)
    decay = rng.uniform(0.05, 0.95, (L, N, B))
    bt_rows = np.concatenate(
        [np.eye(N)[:, :, None] + 0.2 * rng.standard_normal((N, N, B)),
         0.2 * rng.standard_normal((N, N, B))], axis=1)
    rhs = rng.standard_normal((L, n2, B))
    return Gt, decay, bt_rows, rhs


CAPACITIES = (16, 32, 48, 64)


def _capacity(n2):
    """The variant the launch picks: the smallest capacity NC >= 2N."""
    return next(nc for nc in CAPACITIES if n2 <= nc)


def _key(x, used):
    """``pivot_key``: the bits of |x| plus 1, 0 for a row that has pivoted."""
    return np.where(used, np.uint64(0), np.abs(x).view(np.uint64) + np.uint64(1))


def _warp_max(keys, wide):
    """``warp_max``: one redux, or for a 64-bit key two (the high words, then
    the low words of the lanes that hold the top high word)."""
    if not wide:
        return keys.max()
    hi, lo = keys >> np.uint64(32), keys & np.uint64(0xFFFFFFFF)
    mh = hi.max()
    return (mh << np.uint64(32)) | np.where(hi == mh, lo, np.uint64(0)).max()


def _pivot(col, used, ck, wide):
    """The pivot row of a step: each warp's candidate is the lowest lane
    that holds its largest key (the key of row r sits in lane r CS + ck),
    then the first warp with the largest key."""
    best_key, best_row = None, None
    for w in range(len(col) // ROWS_PER_WARP):
        rows = np.arange(w * ROWS_PER_WARP, (w + 1) * ROWS_PER_WARP)
        keys = np.zeros(32, np.uint64)
        keys[(rows - rows[0]) * CS + ck] = _key(col[rows], used[rows])
        top = _warp_max(keys, wide)
        row = rows[0] + int(np.flatnonzero(keys == top)[0]) // CS
        if best_key is None or top > best_key:
            best_key, best_row = top, row
    return best_row


def _kernel_model(Gt, decay, bt_rows, rhs, itemsize=8):
    """numpy model of kernel 7, one lane at a time (see the module
    docstring); ``itemsize`` picks the 32- or 64-bit pivot keys.  Returns
    x (L, 2N, B) and the unknown each row of the capacity pivoted for,
    (L, NC, B)."""
    L, n2, _, B = Gt.shape
    N = n2 // 2
    NC = _capacity(n2)
    NH, RHS = NC // 2, NC + NC // 2
    cols = np.arange(n2)
    x = np.empty((L, n2, B))
    var_all = np.empty((L, NC, B), int)
    for b in range(B):
        G, r = Gt[..., b], rhs[..., b]
        # the decays of Mtop's and of Mbot's columns
        top_scale = [np.where(cols < N, decay[l, cols % N, b], 1.0) for l in range(L)]
        bot_scale = [np.where(cols < N, 1.0, decay[l, cols % N, b]) for l in range(L)]
        Mtop = [G[l] * top_scale[l][None] for l in range(L)]
        Mbot = [G[l] * bot_scale[l][None] for l in range(L)]
        Hs, gs = [], []
        C = None
        for l in range(L):
            last = l == L - 1
            a = np.zeros((NC, RHS + 1))
            a[:N, :n2] = (1.0 if l == 0 else -1.0) * Mbot[l][N:]
            a[N:n2, :n2] = bt_rows[..., b] if last else Mtop[l][:N]
            pads = np.arange(n2, NC)
            a[pads, pads] = 1.0
            if not last:
                a[np.arange(N, n2), NC + np.arange(N)] = 1.0
            a[:n2, RHS] = r[l]
            if l > 0:
                for k in range(N):
                    a[:N, :n2] += C[:, k, None] * Mbot[l][k][None]
                a[:N, RHS] -= C[:, N]
            used = np.zeros(NC, bool)
            var, rcp = np.full(NC, -1), np.ones(NC)
            for k in range(NC):
                pr = _pivot(a[:, k], used, k % CS, itemsize == 8)
                rpv = 1.0 / a[pr, k]
                f = a[:, k] * rpv
                f[pr] = 0.0
                a[:, k + 1:] -= f[:, None] * a[pr, k + 1:][None]
                used[pr], var[pr], rcp[pr] = True, k, rpv
            HG = np.zeros((NC, NH + 1))
            for i in np.flatnonzero(var < n2):
                if not last:
                    HG[var[i], :NH] = a[i, NC:RHS] * rcp[i]
                HG[var[i], NH] = a[i, RHS] * rcp[i]
            Hs.append(HG[:n2, :N])
            gs.append(HG[:n2, NH])
            var_all[l, :, b] = var
            if not last:
                lo = Mtop[l][N:]
                C = np.zeros((N, N + 1))
                for k in range(n2):
                    C[:, :N] += lo[:, k, None] * Hs[-1][k][None]
                    C[:, N] += lo[:, k] * gs[-1][k]
        x[L - 1, :, b] = gs[-1]
        for l in range(L - 2, -1, -1):
            # four parts of w (every fourth column), added pairwise; two of
            # H_l w (the even and the odd unknowns)
            parts = np.zeros((4, N))
            for j in range(n2):
                parts[j % 4] += Mbot[l + 1][:N, j] * x[l + 1, j, b]
            w = (parts[0] + parts[1]) + (parts[2] + parts[3])
            halves = np.zeros((2, n2))
            for k in range(N):
                halves[k % 2] += Hs[l][:, k] * w[k]
            x[l, :, b] = gs[l] + (halves[0] + halves[1])
    return x, var_all


def _jax_x(ops):
    jops = [jnp.asarray(o) for o in ops]
    return np.asarray(jbt.solve_block_tridiag_lanes(*jbt.assemble_bvp_blocks(*jops[:3]), jops[3]))


def _close(x, x_ref):
    # the same pivoted elimination in f64 on a well-conditioned system:
    # agreement to roundoff, 1e-10 relative leaves a wide margin
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12 * np.abs(x_ref).max())


@pytest.mark.parametrize("L,N,zero_lead,itemsize", [(3, 17, False, 8), (3, 24, False, 4), (2, 24, True, 8),
                                                    (3, 32, False, 8), (1, 25, False, 4), (2, 32, True, 4),
                                                    (3, 1, False, 8), (2, 1, False, 4), (3, 8, False, 4),
                                                    (2, 15, True, 8), (3, 16, False, 8), (1, 16, False, 4)])
def test_model_matches_jax(L, N, zero_lead, itemsize):
    """The model within 1e-10 of the JAX package at 2N = 2, 16, 30, 32, 34,
    48, 50 and 64 (in each capacity, padded and exact), L = 1 included; the
    elimination pivots off the diagonal, and the padded rows pivot for the
    padded unknowns."""
    ops = _operands(L, N, 2, seed=70 + L + N)
    if zero_lead:
        # D_0[0, 0] = Mbot_0[N, 0] = 0: an unpivoted elimination divides by zero
        ops[0][:, N, 0, :] = 0.0
    x, var = _kernel_model(*ops, itemsize=itemsize)
    assert np.isfinite(x).all()
    _close(x, _jax_x(ops))
    n2, NC = 2 * N, _capacity(2 * N)
    assert (var[:, :n2] != np.arange(n2)[None, :, None]).any()
    assert (var[:, n2:] == np.arange(n2, NC)[None, :, None]).all()


def _tied(L, N, ties, seed):
    """Operands whose D_0 (lane 0) holds its largest |entry| of column 0 at
    the rows ``ties``, with signs that alternate; the rest of the column is
    cut to |entry| <= 1.  D_0[i, 0] is G_0[N + i, 0] for i < N and
    G_0[i - N, 0] d_0[0] below."""
    ops = _operands(L, N, 2, seed)
    G, d = ops[0], ops[1]
    d[0, 0, 0] = 0.5        # a power of two: G d is exact, and the tie with it
    src = lambda i: (N + i, 1.0) if i < N else (i - N, d[0, 0, 0])
    for i in range(2 * N):
        row, scale = src(i)
        G[0, row, 0, 0] = np.clip(G[0, row, 0, 0] * scale, -1.0, 1.0) / scale
    for k, i in enumerate(ties):
        row, scale = src(i)
        G[0, row, 0, 0] = 5.0 * (-1.0) ** k / scale
    return ops


@pytest.mark.parametrize("N,ties,winner,itemsize", [(24, (40, 20, 5), 5, 4), (24, (45, 19), 19, 8),
                                                    (32, (63, 31, 12), 12, 8), (17, (30, 18), 18, 4),
                                                    (16, (31, 16, 3), 3, 8), (16, (25, 17), 17, 4)])
def test_tied_pivots_take_the_lowest_row(N, ties, winner, itemsize):
    """Column 0 of D_0 holds its largest |entry| at several rows, in one
    warp or in different warps: the lowest row pivots for unknown 0, and x
    still matches the JAX package to 1e-10."""
    ops = _tied(3, N, ties, seed=N + winner)
    x, var = _kernel_model(*ops, itemsize=itemsize)
    assert var[0, winner, 0] == 0 and all(var[0, r, 0] != 0 for r in ties if r != winner)
    _close(x, _jax_x(ops))


@pytest.mark.parametrize("NC", [16, 32, 64])
def test_pivot_scan_keys_and_ties(NC):
    """The per-warp scan with 32- and 64-bit keys over the rows of a
    capacity (one warp at NC = 16, two at 32, four at 64): the largest
    |entry| of the unused rows, the lowest row on a tie, whichever warp
    holds it."""
    cases = {64: [([40, 7, 5], 5), ([63, 33], 33), ([31, 32], 31), ([1, 2, 3], 1)],
             32: [([30, 7, 5], 5), ([31, 17], 17), ([15, 16], 15), ([1, 2, 3], 1)],
             16: [([14, 7, 5], 5), ([15, 9], 9), ([1, 2, 3], 1)]}[NC]
    for rows, want in cases:
        col = np.zeros(NC)
        col[rows] = [(-1.0) ** k * 2.0 for k in range(len(rows))]
        for ck in (0, 1):
            for wide in (False, True):
                assert _pivot(col, np.zeros(NC, bool), ck, wide) == want
    used = np.zeros(NC, bool)
    used[[5, 1]] = True
    col = np.zeros(NC)
    col[[1, 5, 9, NC - 4]] = 3.0
    assert _pivot(col, used, 1, True) == 9
    # 64-bit keys that differ in the low word alone
    col = np.zeros(NC)
    col[NC // 4 + 4], col[NC - 14] = 1.0, np.nextafter(1.0, 2.0)
    assert _pivot(col, np.zeros(NC, bool), 0, True) == NC - 14


@pytest.mark.parametrize("L,N,B", [(3, 17, 3), (2, 24, 4), (1, 24, 2), (3, 32, 2)])
def test_cpu_solve_matches_jax(L, N, B):
    """`solve_bvp_fused` on CPU tensors (its plain version) at 2N = 34, 48
    and 64 against the JAX package; it counts no launch."""
    ops = _operands(L, N, B, seed=90 + L + N)
    before = profiling.recorded()["launches"]
    x = cuda_blocktri.solve_bvp_fused(*(torch.as_tensor(o) for o in ops)).numpy()
    assert profiling.recorded()["launches"] == before
    _close(x, _jax_x(ops))


def test_wrapper_refuses_non_cuda_tensors():
    """Neither CPU nor CUDA tensors: a ValueError naming CUDA, at 2N = 48
    and past the fused kernels' 64; kernel 7's own entry point takes CUDA
    tensors alone."""
    meta = lambda n2: [torch.empty(s, device="meta")
                       for s in ((2, n2, n2, 8), (2, n2 // 2, 8), (n2 // 2, n2, 8), (2, n2, 8))]
    for n2 in (48, 66):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_blocktri.solve_bvp_fused(*meta(n2))
    cpu = [torch.zeros(o.shape, dtype=torch.float64) for o in meta(48)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blocktri.solve_bvp_fused_wide(*cpu)


@pytest.mark.parametrize("n2", [2, 32, 16, 30, 34, 64])
def test_wide_wrapper_refuses_kernel_2_sizes(monkeypatch, n2):
    """Kernel 2 (2N <= 32) is retired and kernel 7 refuses no even
    2 <= 2N <= 64: its wrapper launches ``bvp_fused_wide`` with (L, 2N, B)
    and a lane-major [H | g] stack (B, L, 2N, N+1), and the kernel's
    dispatch (read from ``csrc/bvp_fused_wide.cu``) picks the smallest
    capacity NC >= 2N, the one `_kernel_model` runs."""
    launched = []
    monkeypatch.setattr(cuda_blocktri, "_check", lambda *args: None)      # CPU tensors stand in
    monkeypatch.setattr(cuda_blocktri, "_launch",
                        lambda name, ops, scratch, x, sizes: launched.append((name, scratch.shape, sizes)) or x)
    L, B = 3, 8
    ops = [torch.zeros(s, dtype=torch.float32)
           for s in ((L, n2, n2, B), (L, n2 // 2, B), (n2 // 2, n2, B), (L, n2, B))]
    cuda_blocktri.solve_bvp_fused_wide(*ops)
    assert launched == [("bvp_fused_wide", (B, L, n2, n2 // 2 + 1), (L, n2, B))]
    src = (Path(cuda_blocktri.__file__).parents[1] / "csrc" / "bvp_fused_wide.cu").read_text()
    body = src[src.index("int dispatch("):]
    body = body[:body.index("\n}\n")]
    assert "n2 < 2 ||" in body and "n2 > N2MAX" in body and "constexpr int N2MAX = 64;" in src
    guarded = [(int(a), int(b)) for a, b in re.findall(r"if \(n2 <= (\d+)\) return launch<T, (\d+)>", body)]
    last = int(re.findall(r"\n  return launch<T, (\d+)>", body)[-1])
    assert all(a == b for a, b in guarded) and [a for a, _ in guarded] + [last] == list(CAPACITIES)
    assert next(nc for nc in [a for a, _ in guarded] + [last] if n2 <= nc) == _capacity(n2)


def _spy(monkeypatch):
    """Count the calls of the two boundary-value routes behind
    `solve_bvp_fused`: the fused solve (``_bvp_fused``, kernel 7 on the
    card) and the generic block-Thomas solve on assembled blocks."""
    calls = {"_bvp_fused": 0, "solve_block_tridiag_lanes_cuda": 0}
    for name in calls:
        wrapped = getattr(cuda_blocktri, name)

        def spy(*ops, _name=name, _wrapped=wrapped):
            calls[_name] += 1
            return _wrapped(*ops)

        monkeypatch.setattr(cuda_blocktri, name, spy)
    return calls


def _small_problem(nquad, seed):
    """Two solves of ``bench.py``'s generator at NQuad = nquad, 2 layers,
    float64 on the CPU."""
    a = bench_arrays(1, seed=seed, nlayers=2, nquad=nquad, nbands=2)
    cfg = pt.DisortConfig(nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=1, nlayers=2, nscoeffs=0,
                          nbdrf=0, has_beam=True, only_flux=True, has_deltam=True)
    return pt.make_batched_problem(cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"], f_arr=a["f_arr"],
                                   dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("nquad,fused", [(48, True), (68, False)])
def test_batched_route(monkeypatch, nquad, fused):
    """The batched solve hands the boundary-value operands to
    `solve_bvp_fused` at every 2N, which routes by width: NQuad = 48
    (2N = 48) takes the fused solve (kernel 7 on the card) and assembles
    no blocks; NQuad = 68 (2N = 68 > 64) assembles the blocks for the
    generic block-Thomas solve (kernel 6 on the card)."""
    calls = _spy(monkeypatch)
    widths = []

    def bvp(*ops):
        widths.append(ops[0].shape[1])
        return cuda_blocktri.solve_bvp_fused(*ops)

    monkeypatch.setattr(batch_solve, "solve_bvp_fused", bvp)
    prob = _small_problem(nquad, seed=nquad)
    fluxes = pt.solve_fluxes(prob, prob.tau_arr)
    assert all(torch.isfinite(f).all() for f in fluxes)
    assert widths == [nquad]
    assert calls == {"_bvp_fused": int(fused), "solve_block_tridiag_lanes_cuda": int(not fused)}


def test_batched_gradient_nquad48_matches_jax(monkeypatch):
    """d loss / d omega at NQuad = 48, loss = sum(fup^2) + sum(fdn fdir)
    (the loss of the card's gradient check), through the fused route's
    Function, against ``jax.grad`` (float64; rtol 1e-8, the bound of
    ``tests/test_torch_grad.py``)."""
    calls = _spy(monkeypatch)
    problem, tau = _problem(2, 1, True, False, False, True, True, S=2, nquad=48, seed=5)
    tau_j = jnp.asarray(tau)

    def jloss(om):
        fup, fdn, fdir = jpar.solve_fluxes(dataclasses.replace(problem, omega_arr=om), tau_j)
        return jnp.sum(fup**2) + jnp.sum(fdn * fdir)

    g_ref = np.asarray(jax.jit(jax.grad(jloss))(problem.omega_arr))
    port = to_port(problem)
    port.omega_arr = port.omega_arr.clone().requires_grad_()
    fup, fdn, fdir = pt.solve_fluxes(port, torch.as_tensor(tau))
    ((fup**2).sum() + (fdn * fdir).sum()).backward()
    g = port.omega_arr.grad.numpy()
    assert calls == {"_bvp_fused": 1, "solve_block_tridiag_lanes_cuda": 0}
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, g_ref, rtol=1e-8, atol=1e-11 * np.abs(g_ref).max())
