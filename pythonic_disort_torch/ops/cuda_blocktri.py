"""The fused BVP solve: CUDA kernel ``csrc/bvp_fused.cu`` and its plain
PyTorch version.

Counterpart of ``pythonic_disort_tpu/ops/pallas_blocktri.py::
solve_bvp_fused_pallas``: the L-layer block-tridiagonal boundary-value
system is assembled from the eigenvector blocks and decays inside the
kernel and solved by block Thomas with partial pivoting.  The plain
version assembles the blocks (`blocktri.assemble_bvp_blocks`) and runs
the pivoted block-Thomas loop (`blocktri.solve_block_tridiag_lanes`).
The solution is unique, so the two are compared directly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .blocktri import assemble_bvp_blocks, solve_block_tridiag_lanes


def solve_bvp_fused_plain(Gt, decay_t, bt_rows, rhs_t) -> torch.Tensor:
    """Plain PyTorch BVP solve; see `solve_bvp_fused` for shapes."""
    return solve_block_tridiag_lanes(*assemble_bvp_blocks(Gt, decay_t, bt_rows), rhs_t)


_FN = {torch.float32: "bvp_fused_f32", torch.float64: "bvp_fused_f64"}


def _kernel(dtype):
    fn = getattr(_build.load("bvp_fused"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(Gt, decay_t, bt_rows, rhs_t) -> None:
    ops = (Gt, decay_t, bt_rows, rhs_t)
    if any(x.device.type != "cuda" or x.device != Gt.device for x in ops):
        raise ValueError("solve_bvp_fused: all operands must be CUDA tensors on one device")
    if Gt.dtype not in _FN or any(x.dtype != Gt.dtype for x in ops):
        raise TypeError(f"solve_bvp_fused: float32 or float64 operands expected, got {[x.dtype for x in ops]}")
    if Gt.dim() != 4:
        raise ValueError(f"solve_bvp_fused: Gt must be (L, 2N, 2N, B), got {tuple(Gt.shape)}")
    L, n2, _, B = Gt.shape
    N = n2 // 2
    want = {"Gt": (L, n2, n2, B), "decay_t": (L, N, B), "bt_rows": (N, n2, B), "rhs_t": (L, n2, B)}
    for name, x in zip(want, ops):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"solve_bvp_fused: {name} must be {want[name]}, got {tuple(x.shape)}")
    if n2 % 2 or not 2 <= n2 <= 32 or L < 1 or B < 1:
        raise ValueError(f"solve_bvp_fused: the kernel takes even 2N <= 32, L >= 1, B >= 1; got {tuple(Gt.shape)}")
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("solve_bvp_fused: contiguous operands expected")
    if any(x.requires_grad for x in ops):
        raise NotImplementedError("solve_bvp_fused: no gradient yet (ROADMAP queue 1, module 8)")


def solve_bvp_fused(Gt, decay_t, bt_rows, rhs_t) -> torch.Tensor:
    """Solve the BVP from its operands; returns x (L, 2N, B).

    ``Gt`` (L, 2N, 2N, B) eigenvector blocks, ``decay_t`` (L, N, B)
    homogeneous decays, ``bt_rows`` (N, 2N, B) bottom boundary rows,
    ``rhs_t`` (L, 2N, B).  CPU tensors take `solve_bvp_fused_plain`; CUDA
    tensors launch the kernel (counted in ``solve_bvp_fused.launches``)
    or raise.
    """
    if all(x.device.type == "cpu" for x in (Gt, decay_t, bt_rows, rhs_t)):
        return solve_bvp_fused_plain(Gt, decay_t, bt_rows, rhs_t)
    _check(Gt, decay_t, bt_rows, rhs_t)
    L, n2, _, B = Gt.shape
    # [H_l | g_l] stack written by the forward sweep, read by the backward
    HG = torch.empty((L, n2, n2 // 2 + 1, B), dtype=Gt.dtype, device=Gt.device)
    x = torch.empty_like(rhs_t)
    err = _kernel(Gt.dtype)(
        Gt.data_ptr(), decay_t.data_ptr(), bt_rows.data_ptr(), rhs_t.data_ptr(),
        HG.data_ptr(), x.data_ptr(), L, n2, B,
        torch.cuda.current_stream(Gt.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bvp_fused kernel launch failed: CUDA error {err}")
    solve_bvp_fused.launches += 1
    return x


solve_bvp_fused.launches = 0
