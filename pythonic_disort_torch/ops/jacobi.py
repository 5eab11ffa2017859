"""Batched symmetric eigendecomposition by two-sided cyclic Jacobi.

Counterpart of ``pythonic_disort_tpu/ops/jacobi.py``.  Large batches of
tiny symmetric matrices are kept in the lanes layout (n, n, B), batch
last, and every round of the round-robin schedule applies disjoint Givens
rotations to rows, then columns; a sweep covers all n(n-1)/2 pairs once,
and the sweep count is fixed by dtype.  Even n has n - 1 rounds of n/2
pairs; odd n (which the JAX package refuses) has n rounds of (n-1)/2
pairs, each row sitting out one round per sweep.

`jacobi_eigh_lanes_raw` runs `jacobi_eigh_lanes_plain` for CPU tensors;
for CUDA tensors it launches ``csrc/jacobi_eigh.cu``
(`cuda_jacobi.jacobi_eigh_lanes`) at even n <= 32, the sizes the TPU
kernel takes, and ``csrc/jacobi_eigh_wide.cu``
(`cuda_jacobi.jacobi_eigh_lanes_wide`) at every other n.  `jacobi_eigh` is the padded (..., n, n) interface with
the first-order rules of the symmetric eigendecomposition, reverse mode
and forward mode; the gradient and tangent path of the eigen stage
(`ops.eig`) runs through it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import cuda_jacobi


def _round_robin_schedule(n: int):
    """Rounds of disjoint pairs covering all n(n-1)/2 pairs once, as
    ``(p, q)`` index arrays of shape (rounds, pairs) with p < q.

    Even n: n - 1 rounds of n/2 pairs (the JAX package's schedule).  Odd
    n: the schedule of n + 1 players with the last one a dummy, each
    round's pair with the dummy dropped: n rounds of (n-1)/2 pairs, the
    row left out idle for the round.  n = 1 has no rounds.
    """
    if n < 1:
        raise ValueError(f"the round-robin Jacobi schedule needs n >= 1, got {n}")
    if n % 2:
        if n == 1:
            return np.zeros((0, 0), dtype=np.int64), np.zeros((0, 0), dtype=np.int64)
        p, q = _round_robin_schedule(n + 1)
        keep = q != n                                   # the dummy is the largest index
        return p[keep].reshape(n, -1), q[keep].reshape(n, -1)
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        rounds.append([(min(a, b), max(a, b)) for a, b in pairs])
        players = [players[0]] + [players[-1]] + players[1:-1]
    arr = np.array(rounds)
    return arr[..., 0], arr[..., 1]


def default_sweeps(n: int, dtype: torch.dtype) -> int:
    """Fixed sweep count: 5 in float32 (4 failed Stamnes golden 5a), 9 in
    float64, for n <= 32; 8 and 12 above."""
    if dtype == torch.float64:
        return 9 if n <= 32 else 12
    return 5 if n <= 32 else 8


def jacobi_eigh_lanes_plain(At: torch.Tensor, sweeps: int):
    """Plain PyTorch lanes Jacobi on ``At`` (n, n, B).

    Returns ``(w (n, B), V (n, n, B))``, unsorted, ``A = V diag(w) V^T``
    per lane.  The rotation of each pair comes from the current matrix
    entries, one (c, s) for both of its rows; a tied pair (equal diagonal
    entries) turns by 45 degrees.
    """
    n = At.shape[0]
    p_sched, q_sched = _round_robin_schedule(n)
    idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=At.device)
    rounds = []
    for p, q in zip(p_sched, q_sched):
        # odd n: the idle row rides along unrotated behind the pairs
        idle = np.setdiff1d(np.arange(n), np.concatenate([p, q]))
        inv = np.empty(n, dtype=np.int64)
        inv[np.concatenate([p, q, idle])] = np.arange(n)
        rounds.append((idx(p), idx(q), idx(idle), idx(inv)))
    diag = idx(np.arange(n))
    Vt = torch.zeros_like(At)
    Vt[diag, diag] = 1.0
    for _ in range(sweeps):
        for p, q, idle, inv in rounds:
            app, aqq, apq = At[p, p], At[q, q], At[p, q]            # (n/2, B)
            theta = (aqq - app) * 0.5
            denom = theta.abs() + torch.sqrt(theta * theta + apq * apq)
            sgn = torch.where(theta >= 0, 1.0, -1.0).to(At.dtype)
            t = torch.where(apq.abs() > 0,
                            sgn * apq / torch.where(denom > 0, denom, torch.ones_like(denom)),
                            torch.zeros_like(apq))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            crow, srow = c[:, None, :], s[:, None, :]
            ccol, scol = c[None], s[None]
            # rows: A <- R^T A
            Ap, Aq = At[p], At[q]
            At = torch.cat([crow * Ap - srow * Aq, srow * Ap + crow * Aq, At[idle]], dim=0)[inv]
            # columns: A <- A R
            Ap, Aq = At[:, p], At[:, q]
            At = torch.cat([ccol * Ap - scol * Aq, scol * Ap + ccol * Aq, At[:, idle]], dim=1)[:, inv]
            # eigenvectors: V <- V R
            Vp, Vq = Vt[:, p], Vt[:, q]
            Vt = torch.cat([ccol * Vp - scol * Vq, scol * Vp + ccol * Vq, Vt[:, idle]], dim=1)[:, inv]
    return At[diag, diag], Vt


def jacobi_eigh_lanes_raw(At: torch.Tensor, sweeps: int | None = None):
    """Unsorted eigendecomposition of lanes operands ``At`` (n, n, B).

    Returns ``(w (n, B), V (n, n, B))``.  CPU tensors take
    `jacobi_eigh_lanes_plain`; CUDA tensors launch a kernel or raise:
    kernel 4 at even n <= 32, the wide kernel at any other n.  Forward
    only: `jacobi_eigh` carries the gradient rule.
    """
    n = At.shape[0]
    if sweeps is None:
        sweeps = default_sweeps(n, At.dtype)
    if At.device.type == "cpu":
        return jacobi_eigh_lanes_plain(At, sweeps)
    if n % 2 == 0 and n <= cuda_jacobi.NARROW_MAX:
        return cuda_jacobi.jacobi_eigh_lanes(At, sweeps)
    return cuda_jacobi.jacobi_eigh_lanes_wide(At, sweeps)


def _gap_inverse(w):
    """``F_ij = 1/(w_j - w_i)`` where the gap is nonzero, 0 where it is zero."""
    gap = w[:, None, :] - w[:, :, None]                             # w_j - w_i
    return torch.where(gap != 0, 1.0 / torch.where(gap == 0, torch.ones_like(gap), gap),
                       torch.zeros_like(gap))


class _JacobiEigh(torch.autograd.Function):
    """``(w, V) = eigh(A)`` on (B, n, n).  Its differential, the rule of
    the JAX package's ``_eigh_jvp_rule``: with ``S = V^T dA V``,
    ``dw = diag(S)`` and ``dV = V (F o S)`` (`_gap_inverse`).  ``jvp`` is
    that differential at the outputs as returned (sorted or not), and
    ``backward`` its transpose, a ``disort.grad.eig`` span."""

    @staticmethod
    def forward(ctx, A, sweeps, sort):
        n = A.shape[-1]
        w_l, V_l = jacobi_eigh_lanes_raw(A.detach().permute(1, 2, 0).contiguous(), sweeps)
        w, V = w_l.T, V_l.permute(2, 0, 1)                          # (B, n), (B, n, n)
        if sort:
            order = torch.argsort(w, dim=-1)
            w = torch.take_along_dim(w, order, dim=-1)
            V = torch.take_along_dim(V, order[:, None, :].expand(-1, n, -1), dim=-1)
        w, V = w.contiguous(), V.contiguous()
        ctx.save_for_backward(w, V)
        ctx.save_for_forward(w, V)
        return w, V

    @staticmethod
    def jvp(ctx, dA, _sweeps, _sort):
        w, V = ctx.saved_tensors
        S = V.mT @ dA @ V
        return torch.diagonal(S, dim1=-2, dim2=-1), V @ (_gap_inverse(w) * S)

    @staticmethod
    @once_differentiable
    def backward(ctx, w_bar, V_bar):
        w, V = ctx.saved_tensors
        with span("disort.grad.eig", V.device):
            inner = torch.zeros_like(V) if V_bar is None else _gap_inverse(w) * (V.mT @ V_bar)
            if w_bar is not None:
                inner = inner + torch.diag_embed(w_bar)
            return V @ inner @ V.mT, None, None


def jacobi_eigh(A: torch.Tensor, sweeps: int | None = None, sort: bool = True):
    """Eigendecomposition of symmetric ``A`` (..., n, n), batched.

    Returns ``(w (..., n), V (..., n, n))`` with ``A = V diag(w) V^T``,
    eigenvalues ascending (``sort=False`` leaves them in the order the
    sweeps produce).  First-order derivatives in reverse mode
    (``torch.autograd``) and forward mode (``torch.autograd.forward_ad``).
    """
    n = A.shape[-1]
    batch_shape = tuple(A.shape[:-2])
    w, V = _JacobiEigh.apply(A.reshape(-1, n, n), sweeps, sort)
    return w.reshape(batch_shape + (n,)), V.reshape(batch_shape + (n, n))
