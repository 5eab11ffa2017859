"""The fused eigen stage: CUDA kernel ``csrc/eig_stage.cu`` and its plain
PyTorch version.

Counterpart of ``pythonic_disort_tpu/ops/pallas_eig.py``.  Per lane b of
the lanes-layout operands ``At``, ``Bt`` (n, n, B)::

    L = chol(-Bt);  M = L^T (-At) L;  K^2, Z = eigh(M);  K = sqrt(max(K^2, tiny))
    V = L^-T Z,  Yr = -(L Z) / K,  Pr = (L Z)^T,  Qr = -K V^T

`eig_stage_lanes` launches the kernel for CUDA tensors and runs
`eig_stage_lanes_plain` for CPU tensors.  Both diagonalize M by Jacobi
(the kernel one-sided, the plain version two-sided, the JAX package's
CPU route ``_eig_stage_lanes_jnp``), which keeps the relative digits of a
small eigenvalue K^2 near omega = 1, where LAPACK's ``eigh`` in float32
is accurate only to about eps ||M||.  Both leave the eigen columns
unsorted, each in its own order, which no consumer depends on: the
boundary-value coefficients adapt.
"""

from __future__ import annotations

import functools

import torch

from ..utils.profiling import count
from . import _build
from .jacobi import default_sweeps, jacobi_eigh_lanes_plain


STAGE_MAX = 32    # the kernel takes even n up to this (ops/eig.py routes the rest)


def jacobi_sweeps(dtype: torch.dtype) -> int:
    """Fixed one-sided Jacobi sweep count for n <= 32 (ops/jacobi.py):
    5 in float32 (4 failed Stamnes golden 5a), 9 in float64."""
    return 9 if dtype == torch.float64 else 5


def eig_stage_lanes_plain(At: torch.Tensor, Bt: torch.Tensor):
    """Plain PyTorch eigen stage on (n, n, B) lanes operands, on any device.

    Returns ``(K (n, B), V, Yr, Pr, Qr (n, n, B))``, the eigen columns
    unsorted: M = L^T (-At) L is diagonalized by the plain two-sided
    Jacobi (`jacobi.jacobi_eigh_lanes_plain`, `jacobi.default_sweeps`).
    """
    A = At.permute(2, 0, 1)
    Bm = Bt.permute(2, 0, 1)
    L = torch.linalg.cholesky(-Bm)
    M = L.transpose(-1, -2) @ (-A) @ L
    K2, Z = jacobi_eigh_lanes_plain(M.permute(1, 2, 0), default_sweeps(At.shape[0], At.dtype))
    K2, Z = K2.T, Z.permute(2, 0, 1)
    K = torch.sqrt(torch.clamp(K2, min=torch.finfo(At.dtype).tiny))
    V = torch.linalg.solve_triangular(L.transpose(-1, -2), Z, upper=True)
    LZ = L @ Z
    Yr = -LZ / K[:, None, :]
    Pr = LZ.transpose(-1, -2)
    Qr = -K[:, :, None] * V.transpose(-1, -2)
    lanes = lambda x: x.permute(1, 2, 0).contiguous()
    return K.T.contiguous(), lanes(V), lanes(Yr), lanes(Pr), lanes(Qr)


@functools.cache
def stage_rows(n: int) -> int:
    """Row capacity of the kernel variant that ``csrc/eig_stage.cu``'s
    dispatch launches at width n (16, 24 or 32; 0 where it refuses n),
    asked of the built library, so that the rule lives in one place."""
    return _build.entry("eig_stage", part="rows")(n)


def _check(At: torch.Tensor, Bt: torch.Tensor) -> None:
    if At.device.type != "cuda" or Bt.device != At.device:
        raise ValueError("eig_stage_lanes: At and Bt must be CUDA tensors on one device")
    if At.dtype not in _build.SUFFIX or Bt.dtype != At.dtype:
        raise TypeError(f"eig_stage_lanes: float32 or float64 expected, got {At.dtype}/{Bt.dtype}")
    if At.dim() != 3 or At.shape[0] != At.shape[1] or Bt.shape != At.shape:
        raise ValueError(f"eig_stage_lanes: (n, n, B) operands expected, got {tuple(At.shape)}, {tuple(Bt.shape)}")
    n, _, B = At.shape
    if n % 2 or not 2 <= n <= STAGE_MAX or B < 1:
        # one row per thread of a warp; ops/eig.py routes other widths elsewhere
        raise ValueError(f"eig_stage_lanes: the kernel takes even n <= {STAGE_MAX} and B >= 1, got {tuple(At.shape)}")
    if not (At.is_contiguous() and Bt.is_contiguous()):
        raise ValueError("eig_stage_lanes: contiguous operands expected")
    if At.requires_grad or Bt.requires_grad:
        raise NotImplementedError(
            "eig_stage_lanes: the kernel takes no gradient; ops.eig.disort_eigh_lanes routes operands "
            "that require one through _eig_stage_ad and the Jacobi kernel (ops/jacobi.py)")
    _build.refuse_tangents("eig_stage_lanes", (At, Bt),
                           "ops.eig.disort_eigh_lanes routes dual operands through _eig_stage_ad")


def eig_stage_lanes(At: torch.Tensor, Bt: torch.Tensor):
    """Fused eigen stage on (n, n, B) lanes operands.

    CPU tensors take `eig_stage_lanes_plain`; CUDA tensors launch the
    kernel (counted under ``eig_stage``; a launch of the variant with
    24-entry rows also in the counter ``eig_stage_rows24`` while a
    profiler runs) or raise.
    """
    if At.device.type == "cpu" and Bt.device.type == "cpu":
        return eig_stage_lanes_plain(At, Bt)
    _check(At, Bt)
    n, _, B = At.shape
    K = torch.empty((n, B), dtype=At.dtype, device=At.device)
    V, Yr, Pr, Qr = (torch.empty_like(At) for _ in range(4))
    _build.launch("eig_stage", At.dtype, At.device, At.data_ptr(), Bt.data_ptr(), K.data_ptr(), V.data_ptr(),
                  Yr.data_ptr(), Pr.data_ptr(), Qr.data_ptr(), n, B, jacobi_sweeps(At.dtype))
    if stage_rows(n) == 24:
        count("eig_stage_rows24")
    return K, V, Yr, Pr, Qr
