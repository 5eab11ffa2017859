"""The batched two-sided Jacobi eigendecomposition: CUDA kernel
``csrc/jacobi_eigh.cu``.

Counterpart of ``pythonic_disort_tpu/ops/pallas_jacobi.py::
jacobi_eigh_lanes_pallas``.  Its plain PyTorch version is
`jacobi.jacobi_eigh_lanes_plain`, which `jacobi.jacobi_eigh_lanes_raw`
runs for CPU tensors.  The two agree on the eigenpairs but not on their
order or signs: the kernel steers its rotations by a carried diagonal, as
the TPU kernel does.  Both turn a tied pair by 45 degrees, where the TPU
kernel skips it for the round.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_FN = {torch.float32: "jacobi_eigh_f32", torch.float64: "jacobi_eigh_f64"}


def _kernel(dtype):
    fn = getattr(_build.load("jacobi_eigh"), _FN[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(At: torch.Tensor) -> None:
    if At.device.type != "cuda":
        raise ValueError("jacobi_eigh_lanes: At must be a CUDA tensor")
    if At.dtype not in _FN:
        raise TypeError(f"jacobi_eigh_lanes: float32 or float64 expected, got {At.dtype}")
    if At.dim() != 3 or At.shape[0] != At.shape[1]:
        raise ValueError(f"jacobi_eigh_lanes: (n, n, B) operand expected, got {tuple(At.shape)}")
    n, _, B = At.shape
    if n % 2 or not 2 <= n <= 32 or B < 1:
        # the round-robin schedule pairs rows; one row per thread of a warp
        raise ValueError(f"jacobi_eigh_lanes: the kernel takes even n <= 32 and B >= 1, got {tuple(At.shape)}")
    if not At.is_contiguous():
        raise ValueError("jacobi_eigh_lanes: contiguous operand expected")


def jacobi_eigh_lanes(At: torch.Tensor, sweeps: int):
    """Launch the kernel on ``At`` (n, n, B), a CUDA tensor; returns
    ``(w (n, B), V (n, n, B))``, unsorted.  Counted in
    ``jacobi_eigh_lanes.launches``."""
    _check(At)
    n, _, B = At.shape
    w = torch.empty((n, B), dtype=At.dtype, device=At.device)
    V = torch.empty_like(At)
    err = _kernel(At.dtype)(At.data_ptr(), w.data_ptr(), V.data_ptr(), n, B, sweeps,
                            torch.cuda.current_stream(At.device).cuda_stream)
    if err:
        raise RuntimeError(f"jacobi_eigh kernel launch failed: CUDA error {err}")
    jacobi_eigh_lanes.launches += 1
    return w, V


jacobi_eigh_lanes.launches = 0
