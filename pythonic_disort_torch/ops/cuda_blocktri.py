"""The block-Thomas CUDA kernels and their plain PyTorch versions.

Counterpart of ``pythonic_disort_tpu/ops/pallas_blocktri.py``.

`solve_bvp_fused` (for ``solve_bvp_fused_pallas``): the L-layer
block-tridiagonal boundary-value system is assembled from the eigenvector
blocks and decays inside the kernel and solved by block Thomas with
partial pivoting, at the 2N <= 64 the TPU kernel takes:
``csrc/bvp_fused_wide.cu`` (kernel 7, `solve_bvp_fused_wide`; it took over
2N <= 32 from kernel 2, ``csrc/bvp_fused.cu``, which is retired).  Its
plain version assembles the blocks (`blocktri.assemble_bvp_blocks`) and
runs the pivoted block-Thomas loop (`blocktri.solve_block_tridiag_lanes`).  Above 2N = 64,
where the JAX package runs its jnp path, `solve_bvp_fused` assembles the
blocks and hands them to `solve_block_tridiag_lanes_cuda`: the batched
solve calls `solve_bvp_fused` at every 2N, and the choice of route by
width lives here alone.

`solve_block_tridiag_lanes_cuda` (for ``solve_block_tridiag_lanes_pallas``):
the same pivoted block Thomas on explicit dense lower/diag/upper blocks.
It launches ``csrc/blocktri.cu`` (kernel 3) at n <= 64, the sizes the TPU
kernel takes, and ``csrc/blocktri_wide.cu`` (kernel 6,
`solve_block_tridiag_lanes_wide`) above, where the JAX package runs its
jnp block Thomas.  Their plain version is
`blocktri.solve_block_tridiag_lanes`.

Every kernel is launched through `_build.launch` after the operands are
checked (CUDA tensors on one device, float32 or float64, the shapes, the
sizes the kernel takes, contiguous, no forward-mode tangent); each
launch is counted under its source's name (``bvp_fused_wide``,
``blocktri``, ``blocktri_wide``).

The solution of either system is unique, so a kernel and its plain
version are compared directly on x.

Both are differentiable (first order, reverse mode), each through a
``torch.autograd.Function`` whose backward solves the transposed
block-tridiagonal system with the generic kernel, as the JAX package's
custom VJPs do: `solve_block_tridiag_lanes_cuda` returns the outer-product
cotangents of its blocks; `solve_bvp_fused` writes the transposed blocks
from its operands (`transposed_bvp_blocks`) and pulls the cotangents back
through the assembly in closed form (`bvp_cotangents`), so that its
backward holds three blocks' worth of memory at once, not nine.  Each
backward is a ``disort.grad.bvp`` span.  On CPU tensors the same
Functions run the plain versions.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _build
from .blocktri import assemble_bvp_blocks, solve_block_tridiag_lanes


def solve_bvp_fused_plain(Gt, decay_t, bt_rows, rhs_t) -> torch.Tensor:
    """Plain PyTorch BVP solve; see `solve_bvp_fused` for shapes."""
    return solve_block_tridiag_lanes(*assemble_bvp_blocks(Gt, decay_t, bt_rows), rhs_t)


FUSED_BLOCK_MAX = 64    # largest block size 2N of the fused solve (csrc/bvp_fused_wide.cu)
BLOCK_MAX = 64          # largest block size n of csrc/blocktri.cu


def _check(name, operands: dict, want: dict) -> None:
    """What the kernels ask of their operands (label -> tensor): CUDA
    tensors on one device, one of float32/float64, the shapes ``want``,
    contiguous, without a forward-mode tangent."""
    ops = tuple(operands.values())
    if any(x.device.type != "cuda" or x.device != ops[0].device for x in ops):
        raise ValueError(f"{name}: all operands must be CUDA tensors on one device")
    if ops[0].dtype not in _build.SUFFIX or any(x.dtype != ops[0].dtype for x in ops):
        raise TypeError(f"{name}: float32 or float64 operands expected, got {[x.dtype for x in ops]}")
    for label, x in operands.items():
        if tuple(x.shape) != want[label]:
            raise ValueError(f"{name}: {label} must be {want[label]}, got {tuple(x.shape)}")
    if not all(x.is_contiguous() for x in ops):
        raise ValueError(f"{name}: contiguous operands expected")
    _build.refuse_tangents(name, ops, "forward mode through the block-Thomas solve is not supported, as in "
                           "the JAX package, whose solve is a custom VJP")


def _launch(name, operands, scratch, x, sizes) -> torch.Tensor:
    _build.launch(name, x.dtype, x.device, *(t.data_ptr() for t in (*operands, scratch, x)), *sizes)
    return x


def _check_bvp(name, Gt, decay_t, bt_rows, rhs_t):
    """`_check` for the boundary-value operands; returns (L, 2N, B)."""
    if Gt.dim() != 4:
        raise ValueError(f"{name}: Gt must be (L, 2N, 2N, B), got {tuple(Gt.shape)}")
    L, n2, _, B = Gt.shape
    N = n2 // 2
    _check(name, dict(Gt=Gt, decay_t=decay_t, bt_rows=bt_rows, rhs_t=rhs_t),
           dict(Gt=(L, n2, n2, B), decay_t=(L, N, B), bt_rows=(N, n2, B), rhs_t=(L, n2, B)))
    if n2 % 2 or not 2 <= n2 <= FUSED_BLOCK_MAX or L < 1 or B < 1:
        raise ValueError(
            f"{name}: the fused kernel takes even 2N <= {FUSED_BLOCK_MAX}, L >= 1, B >= 1 (larger blocks go "
            f"through assemble_bvp_blocks and solve_block_tridiag_lanes_cuda); got {tuple(Gt.shape)}")
    return L, n2, B


def _bvp_fused(Gt, decay_t, bt_rows, rhs_t) -> torch.Tensor:
    """`solve_bvp_fused` without its gradient rule."""
    ops = (Gt, decay_t, bt_rows, rhs_t)
    if all(x.device.type == "cpu" for x in ops):
        return solve_bvp_fused_plain(*ops)
    return solve_bvp_fused_wide(*ops)


def solve_bvp_fused_wide(Gt, decay_t, bt_rows, rhs_t) -> torch.Tensor:
    """Launch kernel 7 (``csrc/bvp_fused_wide.cu``) on CUDA operands of
    even 2 <= 2N <= 64 (see `solve_bvp_fused` for shapes); returns x
    (L, 2N, B).  No gradient rule: `solve_bvp_fused` sends that range
    here."""
    ops = (Gt, decay_t, bt_rows, rhs_t)
    L, n2, B = _check_bvp("solve_bvp_fused_wide", *ops)
    # [H_l | g_l] stack, lane-major: written by the forward sweep, read by
    # the backward
    HG = torch.empty((B, L, n2, n2 // 2 + 1), dtype=Gt.dtype, device=Gt.device)
    return _launch("bvp_fused_wide", ops, HG, torch.empty_like(rhs_t), (L, n2, B))


def _check_blocks(name, lower_t, diag_t, upper_t, rhs_t):
    """`_check` for explicit blocks; returns (L, n, B)."""
    if diag_t.dim() != 4 or diag_t.shape[1] != diag_t.shape[2]:
        raise ValueError(f"{name}: diag_t must be (L, n, n, B), got {tuple(diag_t.shape)}")
    L, n, _, B = diag_t.shape
    _check(name, dict(lower_t=lower_t, diag_t=diag_t, upper_t=upper_t, rhs_t=rhs_t),
           dict(lower_t=(L, n, n, B), diag_t=(L, n, n, B), upper_t=(L, n, n, B), rhs_t=(L, n, B)))
    if min(L, n, B) < 1:
        raise ValueError(f"{name}: L, n, B >= 1 expected, got {tuple(diag_t.shape)}")
    return L, n, B


def _blocktri(lower_t, diag_t, upper_t, rhs_t) -> torch.Tensor:
    """`solve_block_tridiag_lanes_cuda` without its gradient rule."""
    name = "solve_block_tridiag_lanes_cuda"
    ops = (lower_t, diag_t, upper_t, rhs_t)
    if all(x.device.type == "cpu" for x in ops):
        return solve_block_tridiag_lanes(*ops)
    L, n, B = _check_blocks(name, *ops)
    if n > BLOCK_MAX:
        return solve_block_tridiag_lanes_wide(*ops)
    # [W_l | g_l] stack, lane-major: written by the forward sweep, read by
    # the backward
    WG = torch.empty((B, L, n, n + 1), dtype=diag_t.dtype, device=diag_t.device)
    return _launch("blocktri", ops, WG, torch.empty_like(rhs_t), (L, n, B))


def solve_block_tridiag_lanes_wide(lower_t, diag_t, upper_t, rhs_t, workspace: bool = False) -> torch.Tensor:
    """Launch kernel 6 on explicit blocks (CUDA tensors, any n >= 1; see
    `solve_block_tridiag_lanes_cuda` for shapes); returns x (L, n, B).
    No gradient rule: `solve_block_tridiag_lanes_cuda` sends n > 64 here,
    forward and backward.  A device workspace holds the augmented block
    where shared memory cannot, or always with ``workspace=True`` (the
    checks' way to run the workspace body)."""
    ops = (lower_t, diag_t, upper_t, rhs_t)
    L, n, B = _check_blocks("solve_block_tridiag_lanes_wide", *ops)
    esz = diag_t.element_size()
    nbytes = (_build.entry("blocktri_wide", diag_t.dtype, "workspace")(n, B)
              or (B * n * (2 * n + 1) * esz if workspace else 0))
    ws = torch.empty(nbytes // esz, dtype=diag_t.dtype, device=diag_t.device) if nbytes else None
    # [W_l | g_l] stack, lane-major: written by the forward sweep, read by
    # the next layer and the backward
    WG = torch.empty((B, L, n, n + 1), dtype=diag_t.dtype, device=diag_t.device)
    x = torch.empty_like(rhs_t)
    _build.launch("blocktri_wide", diag_t.dtype, diag_t.device, *(t.data_ptr() for t in (*ops, WG, x)),
                  None if ws is None else ws.data_ptr(), L, n, B)
    return x


def transposed_system(lower_t, diag_t, upper_t):
    """Blocks of the transposed system: block row l of A^T couples
    y[l-1] through upper[l-1]^T and y[l+1] through lower[l+1]^T.  The
    ignored edge blocks lower[0] and upper[L-1] are dropped."""
    T = lambda m: m.transpose(1, 2)
    zero = torch.zeros_like(diag_t[:1])
    return torch.cat([zero, T(upper_t)[:-1]]), T(diag_t).contiguous(), torch.cat([T(lower_t)[1:], zero])


def block_cotangents(y, x):
    """Cotangents of the lower, diag and upper blocks (L, n, n, B) of a
    solve ``A x = r`` whose adjoint solution is ``y`` (L, n, B)."""
    zero = torch.zeros_like(x[:1])
    x_prev = torch.cat([zero, x[:-1]])
    x_next = torch.cat([x[1:], zero])
    outer = lambda a, b: a[:, :, None, :] * b[:, None, :, :]
    return -outer(y, x_prev), -outer(y, x), -outer(y, x_next)


class _BlockTridiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lower_t, diag_t, upper_t, rhs_t):
        x = _blocktri(lower_t.detach(), diag_t.detach(), upper_t.detach(), rhs_t.detach())
        ctx.save_for_backward(lower_t, diag_t, upper_t, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        lower_t, diag_t, upper_t, x = ctx.saved_tensors
        with span("disort.grad.bvp", ct.device):
            y = _blocktri(*transposed_system(lower_t, diag_t, upper_t), ct.contiguous())
            return (*block_cotangents(y, x), y)


# layers a slab of the pull-back's contraction: bounds its temporaries to
# (SLAB, 2N, N, B)
SLAB = 8


def _column_scales(decay_t):
    """The column scales ``ct = [d | 1]`` and ``cb = [1 | d]`` (L, 2N, B)
    of `blocktri.assemble_bvp_blocks`'s ``Mtop`` and ``Mbot``."""
    one = torch.ones_like(decay_t)
    return torch.cat([decay_t, one], dim=1), torch.cat([one, decay_t], dim=1)


def transposed_bvp_blocks(Gt, decay_t, bt_rows):
    """`transposed_system` of `blocktri.assemble_bvp_blocks`'s blocks, each
    entry written once from the operands into its own (L, 2N, 2N, B)
    tensor: no assembled block and no temporary of a block's size.

    With the column scales ``ct``, ``cb`` (`_column_scales`) and ``H =
    G^T`` per layer, block row l of A^T holds ``diag[l] = [s_l H[:, N:] cb |
    H[:, :N] ct]`` (s_0 = 1, else -1; the right half is ``bt_rows^T`` in the
    last layer), ``lower[l] = [0 | -H[:, :N] cb]`` (l >= 1) and ``upper[l] =
    [H[:, N:] ct | 0]`` (l <= L - 2)."""
    N = Gt.shape[1] // 2
    ct, cb = (c[:, :, None] for c in _column_scales(decay_t))     # (L, 2N, 1, B)
    H = Gt.transpose(1, 2)
    lower, diag, upper = (torch.zeros_like(Gt) for _ in range(3))
    torch.mul(H[:, :, N:], cb, out=diag[:, :, :N])
    diag[1:, :, :N].neg_()
    torch.mul(H[:-1, :, :N], ct[:-1], out=diag[:-1, :, N:])
    diag[-1, :, N:] = bt_rows.transpose(0, 1)
    torch.mul(H[1:, :, :N], cb[1:], out=lower[1:, :, N:])
    lower[1:, :, N:].neg_()
    torch.mul(H[:-1, :, N:], ct[:-1], out=upper[:-1, :, :N])
    return lower, diag, upper


def bvp_cotangents(Gt, decay_t, y, x):
    """Cotangents of ``Gt``, ``decay_t`` and ``bt_rows`` of a BVP solve
    whose solution is ``x`` and adjoint solution ``y`` (L, 2N, B): the
    block cotangents ``-y[l] x[l']^T`` (`block_cotangents`) pulled back
    through `blocktri.assemble_bvp_blocks` in closed form.

    Layer l's ``Mtop`` takes ``a[l] x[l]^T`` and its ``Mbot``
    ``b[l] x[l]^T``, with ``z[l] = [y[l][N:]; y[l+1][:N]]``, ``a[l] =
    -z[l]`` (0 in the last layer), ``b[l] = z[l-1]`` and ``b[0] = [0;
    -y[0][:N]]``.  So ``dG[l] = a[l] (x ct)[l]^T + b[l] (x cb)[l]^T``,
    ``dd[l][j] = x[l][j] (a[l]^T G[l])[j] + x[l][N+j] (b[l]^T G[l])[N+j]``
    and ``dbt_rows = -y[L-1][N:] x[L-1]^T``: one tensor of the blocks'
    size, the cotangent of ``Gt`` itself."""
    L, n2 = Gt.shape[:2]
    N = n2 // 2
    z = torch.cat([y[:-1, N:], y[1:, :N]], dim=1)                  # (L-1, 2N, B)
    a = torch.cat([-z, torch.zeros_like(y[:1])])
    b = torch.cat([torch.cat([torch.zeros_like(y[0, :N]), -y[0, :N]])[None], z])
    xct, xcb = (x * c for c in _column_scales(decay_t))
    dG = a[:, :, None] * xct[:, None]
    dG.addcmul_(b[:, :, None], xcb[:, None])
    dd = torch.empty_like(decay_t)
    for s in range(0, L, SLAB):
        sl = slice(s, s + SLAB)
        ga = (a[sl, :, None] * Gt[sl, :, :N]).sum(1)                # (SLAB, N, B)
        gb = (b[sl, :, None] * Gt[sl, :, N:]).sum(1)
        torch.addcmul(x[sl, :N] * ga, x[sl, N:], gb, out=dd[sl])
    dbt = -y[-1, N:, None] * x[-1, None]
    return dG, dd, dbt


class _BvpFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Gt, decay_t, bt_rows, rhs_t):
        x = _bvp_fused(Gt.detach(), decay_t.detach(), bt_rows.detach(), rhs_t.detach())
        ctx.save_for_backward(Gt, decay_t, bt_rows, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        Gt, decay_t, bt_rows, x = ctx.saved_tensors
        with span("disort.grad.bvp", ct.device):
            blocks = transposed_bvp_blocks(Gt, decay_t, bt_rows)
            y = _blocktri(*blocks, ct.contiguous())
            del blocks
            return (*bvp_cotangents(Gt, decay_t, y, x), y)


def solve_bvp_fused(Gt, decay_t, bt_rows, rhs_t) -> torch.Tensor:
    """Solve the BVP from its operands; returns x (L, 2N, B).

    ``Gt`` (L, 2N, 2N, B) eigenvector blocks, ``decay_t`` (L, N, B)
    homogeneous decays, ``bt_rows`` (N, 2N, B) bottom boundary rows,
    ``rhs_t`` (L, 2N, B).  Up to 2N = 64, CPU tensors take
    `solve_bvp_fused_plain`; CUDA tensors launch kernel 7
    (`solve_bvp_fused_wide`), or raise; the
    backward assembles the blocks and solves the transposed system with
    `solve_block_tridiag_lanes_cuda`'s kernel.  Wider systems, where the
    JAX package runs its jnp path, have their blocks assembled
    (`blocktri.assemble_bvp_blocks`) and solved by
    `solve_block_tridiag_lanes_cuda` (kernel 6 on the card), forward and
    backward.  Differentiable in every operand.
    """
    if Gt.dim() == 4 and Gt.shape[1] > FUSED_BLOCK_MAX:
        return solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(Gt, decay_t, bt_rows), rhs_t)
    return _BvpFused.apply(Gt, decay_t, bt_rows, rhs_t)


def solve_block_tridiag_lanes_cuda(lower_t, diag_t, upper_t, rhs_t) -> torch.Tensor:
    """Block-Thomas solve on explicit blocks; returns x (L, n, B).

    ``lower_t``, ``diag_t``, ``upper_t`` (L, n, n, B) general dense
    blocks, ``rhs_t`` (L, n, B); ``lower_t[0]`` and ``upper_t[-1]`` are
    ignored and may hold anything.  CPU tensors take
    `blocktri.solve_block_tridiag_lanes`; CUDA tensors launch kernel 3 at
    n <= 64 and kernel 6 above (`solve_block_tridiag_lanes_wide`), or
    raise.  Differentiable in every operand: the backward solves the
    transposed system with the same kernel.
    """
    return _BlockTridiag.apply(lower_t, diag_t, upper_t, rhs_t)
