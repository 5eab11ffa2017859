"""Block-tridiagonal solve (block Thomas): plain PyTorch version and the
padded interface.

Counterpart of ``pythonic_disort_tpu/ops/blocktri.py``.  Regrouping the
multi-layer boundary-value system in chunks of 2N rows makes it block
tridiagonal with 2N x 2N blocks.  Block row l reads
``lower[l] x[l-1] + diag[l] x[l] + upper[l] x[l+1] = rhs[l]``, with
``lower[0]`` and ``upper[-1]`` ignored.  Every operand keeps the batch
last: blocks (L, n, n, B), vectors (L, n, B).

Each block elimination is Gauss-Jordan with per-lane partial pivoting:
unpivoted elimination breaks down on strongly peaked phase functions
(Stamnes case 4c has a near-singular leading minor in a boundary block).

`solve_block_tridiag_lanes` is the plain version of both CUDA kernels of
`cuda_blocktri` (the fused boundary-value solve of the batched path and
the generic block-Thomas solve of the single-column path) and the CPU
path of the tests.  `solve_block_tridiag` is the padded interface the
single-column solve calls: it moves the batch into lanes and goes through
`cuda_blocktri.solve_block_tridiag_lanes_cuda`.
"""

from __future__ import annotations

import torch


def gauss_jordan_solve_lanes(D: torch.Tensor, Aug: torch.Tensor) -> torch.Tensor:
    """Solve ``D X = Aug`` per lane with partial pivoting.

    ``D``: (n, n, b); ``Aug``: (n, m, b).  Returns X (n, m, b).
    """
    n = D.shape[0]
    a = torch.cat([D, Aug], dim=1).permute(2, 0, 1).contiguous()   # (b, n, n+m)
    lanes = torch.arange(a.shape[0], device=a.device)
    for k in range(n):
        r = k + torch.argmax(a[:, k:, k].abs(), dim=1)
        row_k = a[:, k].clone()
        a[:, k] = a[lanes, r]
        a[lanes, r] = row_k
        piv = a[:, k] / a[:, k, k:k + 1]
        a = a - a[:, :, k:k + 1] * piv[:, None, :]
        a[:, k] = piv
    return a[:, :, n:].permute(1, 2, 0)


def assemble_bvp_blocks(Gt: torch.Tensor, decay_t: torch.Tensor, bt_rows: torch.Tensor):
    """Lower/diag/upper BVP blocks, each (L, 2N, 2N, B).

    ``Gt``: (L, 2N, 2N, B) eigenvector blocks; ``decay_t``: (L, N, B)
    homogeneous decay factors; ``bt_rows``: (N, 2N, B) bottom boundary
    rows.  The roles match the reference's banded assembly
    (reference ``_solve_for_coeffs.py:276-325``).
    """
    L, n2 = Gt.shape[:2]
    N = n2 // 2
    Mtop = torch.cat([Gt[:, :, :N] * decay_t[:, None], Gt[:, :, N:]], dim=2)
    Mbot = torch.cat([Gt[:, :, :N], Gt[:, :, N:] * decay_t[:, None]], dim=2)
    if L == 1:
        Dg = torch.cat([Mbot[0, N:], bt_rows], dim=0)[None]
        return torch.zeros_like(Dg), Dg, torch.zeros_like(Dg)
    d_top = torch.cat([Mbot[0:1, N:], -Mbot[1:, N:]], dim=0)
    d_bot = torch.cat([Mtop[: L - 1, :N], bt_rows[None]], dim=0)
    Dg = torch.cat([d_top, d_bot], dim=1)
    zN = torch.zeros_like(Mtop[:1, :N])
    zL = torch.zeros_like(Mtop[:, :N])
    lower = torch.cat([torch.cat([zN, Mtop[: L - 1, N:]], dim=0), zL], dim=1)
    upper = torch.cat([zL, torch.cat([-Mbot[1:, :N], zN], dim=0)], dim=1)
    return lower, Dg, upper


def solve_block_tridiag_lanes(lower_t, diag_t, upper_t, rhs_t) -> torch.Tensor:
    """Block-Thomas solve; (L, n, n, B) blocks, rhs (L, n, B) -> x (L, n, B)."""
    L = diag_t.shape[0]
    Ws, gs = [], []
    for l in range(L):
        dhat, rhat = diag_t[l], rhs_t[l]
        if l > 0:
            dhat = dhat - torch.einsum("ikb,kjb->ijb", lower_t[l], Ws[-1])
            rhat = rhat - torch.einsum("ikb,kb->ib", lower_t[l], gs[-1])
        sol = gauss_jordan_solve_lanes(dhat, torch.cat([upper_t[l], rhat[:, None]], dim=1))
        Ws.append(sol[:, :-1])
        gs.append(sol[:, -1])
    xs = [gs[-1]]
    for l in range(L - 2, -1, -1):
        xs.append(gs[l] - torch.einsum("ikb,kb->ib", Ws[l], xs[-1]))
    return torch.stack(xs[::-1])


def solve_block_tridiag(lower, diag, upper, rhs) -> torch.Tensor:
    """Solve a block-tridiagonal system; batched over the middle axes.

    ``lower``, ``diag``, ``upper``: (L, *batch, n, n); ``rhs``:
    (L, *batch, n).  Returns x (L, *batch, n).  The batch axes are
    flattened into lanes for the solver and restored afterwards.
    """
    from .cuda_blocktri import solve_block_tridiag_lanes_cuda

    L, n = diag.shape[0], diag.shape[-1]
    batch_shape = diag.shape[1:-2]
    tmat = lambda x: x.reshape(L, -1, n, n).permute(0, 2, 3, 1).contiguous()
    xs = solve_block_tridiag_lanes_cuda(
        tmat(lower), tmat(diag), tmat(upper),
        rhs.reshape(L, -1, n).permute(0, 2, 1).contiguous())
    return xs.permute(0, 2, 1).reshape((L,) + tuple(batch_shape) + (n,))
