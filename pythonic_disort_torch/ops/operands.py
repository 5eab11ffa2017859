"""The boundary-value operands of the batched solve: CUDA kernel
``csrc/bvp_operands.cu`` and its plain PyTorch version.

Between the eigen stage and the boundary-value solve,
``models/disort/batch_solve.py`` needs, per lane ``q = (m, l, s)`` of
the eigen stage's lanes (mode-major, solve fastest):

- the eigenvector blocks ``G = [a b; b a]``, ``a = (X + Y) / 2``,
  ``b = (X - Y) / 2``, in the L-major layout the BVP kernels read,
  ``Gt`` (L, 2N, 2N, NF*S);
- with a beam, its particular solution ``B_l`` (2N, NF*L*S): ``y`` from
  the rows of P and Q applied to ``xp`` and ``xn``, ``z = y / (1/mu0 +
  K)``, ``B_l = G z``.

The JAX package computes them in jnp and leaves them to XLA's fusion; it
has no kernel here.  `bvp_operands_plain` is the port's tensor code for
them, as the solve ran it inline (its operations and their order kept, so
CPU results keep their bits).  `bvp_operands` launches the kernel on the
card, which reads X, Y, P and Q once and writes ``Gt`` once (its bound is
bytes), with ``Gt`` the plain code's bits and ``B_l`` within roundoff of
it (its dot products sum in another order than cuBLAS's gemv).  The plain
code runs on the CPU, and for operands that take a gradient or carry a
forward-mode tangent (`_plain_only`), which the kernel carries neither.
"""

from __future__ import annotations

import torch

from . import _build

_NAME = "bvp_operands"


def mat_lanes(A, x):
    """(n, k, q), (k, q) -> (n, q)."""
    return torch.einsum("ikq,kq->iq", A, x)


def bvp_operands_plain(X, Y, P, Q, K_full, L, S, xp=None, xn=None, mu0=None):
    """The operands in plain PyTorch, on any device; see `bvp_operands`."""
    N, _, lanes = X.shape
    NF = lanes // (L * S)
    a_blk = 0.5 * (X + Y)
    b_blk = 0.5 * (X - Y)
    G_l = torch.cat(
        [torch.cat([a_blk, b_blk], dim=1), torch.cat([b_blk, a_blk], dim=1)], dim=0)
    B_l = None
    if xp is not None:
        # ---- beam particular solution (reference _solve...py:209-231) ----
        Pp, Pn = mat_lanes(P, xp), mat_lanes(P, xn)
        Qp, Qn = mat_lanes(Q, xp), mat_lanes(Q, xn)
        y_top = 0.5 * (Pp + Qp + Pn - Qn)
        y_bot = 0.5 * (Pp - Qp + Pn + Qn)
        mu0_q = mu0[:, None].expand(S, L).T[None].expand(NF, L, S).reshape(lanes)
        ycat = torch.cat([y_top, y_bot], dim=0) / (1.0 / mu0_q + K_full)
        zt, zb = ycat[:N], ycat[N:]
        B_l = torch.cat([mat_lanes(a_blk, zt) + mat_lanes(b_blk, zb),
                         mat_lanes(b_blk, zt) + mat_lanes(a_blk, zb)], dim=0)
    Gt = G_l.reshape(2 * N, 2 * N, NF, L, S).movedim(3, 0).reshape(L, 2 * N, 2 * N, NF * S)
    return Gt, B_l


def mode0_blocks(Gt, S):
    """Mode 0's blocks of every (l, s), ``(L*S, 2N, 2N)`` in (l, s) order:
    the first ``S`` entries of ``Gt``'s last axis, laid out as the lanes
    layout's ``G_l[..., :L*S].permute(2, 0, 1)`` is (the lanes in the
    first axis with unit stride), so the products that read them take the
    same route."""
    L, n2 = Gt.shape[0], Gt.shape[1]
    return Gt[..., :S].permute(1, 2, 0, 3).reshape(n2, n2, L * S).permute(2, 0, 1)


def _plain_only(*operands) -> bool:
    """Whether the call needs the plain code on any device: a gradient
    (grad mode on and an operand requiring one) or a forward-mode tangent
    (``_build.has_tangent``), which the kernel carries neither."""
    ops = [x for x in operands if x is not None]
    return ((torch.is_grad_enabled() and any(x.requires_grad for x in ops))
            or any(_build.has_tangent(x) for x in ops))


def _check(X, Y, P, Q, K_full, L, S, xp, xn, mu0) -> None:
    N, _, lanes = X.shape
    shapes = [(X, (N, N, lanes)), (Y, (N, N, lanes)), (K_full, (2 * N, lanes))]
    if xp is not None:
        shapes += [(P, (N, N, lanes)), (Q, (N, N, lanes)), (xp, (N, lanes)), (xn, (N, lanes)), (mu0, (S,))]
    if any(x.device != X.device for x, _ in shapes):
        raise ValueError(f"{_NAME}: CUDA tensors on one device expected")
    if X.dtype not in _build.SUFFIX or any(x.dtype != X.dtype for x, _ in shapes):
        raise TypeError(f"{_NAME}: float32 or float64 operands of one dtype expected")
    if min(N, L, S, lanes) < 1 or lanes % (L * S) or any(x.shape != s for x, s in shapes):
        raise ValueError(f"{_NAME}: X, Y, P, Q (N, N, NF*L*S), K_full (2N, NF*L*S), xp, xn (N, NF*L*S) and "
                         f"mu0 (S,) expected at L = {L}, S = {S}, got X {tuple(X.shape)}")


def bvp_operands(X, Y, P, Q, K_full, L, S, xp=None, xn=None, mu0=None):
    """The BVP operands ``(Gt (L, 2N, 2N, NF*S), B_l (2N, NF*L*S) or None)``.

    ``X``, ``Y``, ``P``, ``Q`` (N, N, NF*L*S): the eigen stage's outputs;
    ``K_full`` (2N, NF*L*S): ``[-K; K]``; with a beam ``xp``, ``xn``
    (N, NF*L*S), the beam's source terms over mu, and ``mu0`` (S,);
    without one (all three None) ``B_l`` is None.  CPU tensors, and
    operands that take a gradient or carry a forward-mode tangent, take
    `bvp_operands_plain`; other CUDA tensors launch the kernel (counted
    under ``bvp_operands``) or raise.
    """
    if (xp is None) != (xn is None) or (xp is None) != (mu0 is None):
        raise ValueError(f"{_NAME}: xp, xn and mu0 go together (a beam) or not at all")
    if X.device.type != "cuda" or _plain_only(X, Y, P, Q, K_full, xp, xn, mu0):
        return bvp_operands_plain(X, Y, P, Q, K_full, L, S, xp, xn, mu0)
    beam = xp is not None
    # contiguous operands; the kernel reads P, Q, xp, xn and mu0 only with a beam
    X, Y, K_full = (x.contiguous() for x in (X, Y, K_full))
    P, Q, xp, xn, mu0 = (x.contiguous() for x in (P, Q, xp, xn, mu0)) if beam else (None,) * 5
    _check(X, Y, P, Q, K_full, L, S, xp, xn, mu0)
    N, _, lanes = X.shape
    NF = lanes // (L * S)
    Gt = torch.empty((L, 2 * N, 2 * N, NF * S), dtype=X.dtype, device=X.device)
    B_l = torch.empty((2 * N, lanes), dtype=X.dtype, device=X.device) if beam else None
    ptr = lambda x: None if x is None else x.data_ptr()
    _build.launch(_NAME, X.dtype, X.device, *map(ptr, (X, Y, P, Q, K_full, xp, xn, mu0, Gt, B_l)), N, L, S, NF)
    return Gt, B_l
