"""The batched two-sided Jacobi eigendecomposition: CUDA kernels
``csrc/jacobi_eigh.cu`` and ``csrc/jacobi_eigh_wide.cu``.

Counterparts of ``pythonic_disort_tpu/ops/pallas_jacobi.py::
jacobi_eigh_lanes_pallas``.  `jacobi_eigh_lanes` (kernel 4) takes what
the TPU kernel takes, even n <= 32; `jacobi_eigh_lanes_wide` (kernel 5)
takes any n >= 1, and `jacobi.jacobi_eigh_lanes_raw` sends it every
other width, where the JAX package runs its jnp Jacobi.  Their plain
PyTorch version is `jacobi.jacobi_eigh_lanes_plain`, which
`jacobi.jacobi_eigh_lanes_raw` runs for CPU tensors.  Kernel 4 and the
plain version agree on the eigenpairs but not on their order or signs:
kernel 4 steers its rotations by a carried diagonal, as the TPU kernel
does; kernel 5 reads them from the matrix, as the plain version does.
All turn a tied pair by 45 degrees, where the TPU kernel skips it for the
round.

Each wrapper checks its operand (a CUDA tensor, float32 or float64,
(n, n, B), contiguous, no forward-mode tangent) and launches through
`_build.launch`, counted under ``jacobi_eigh`` and ``jacobi_eigh_wide``.
The A/B tools also call `jacobi_eigh_lanes_wide` at even n <= 32, as the
baseline kernel 4 has to beat.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

NARROW_MAX = 32    # kernel 4 takes even n up to this


def _check(name: str, At: torch.Tensor) -> None:
    if At.device.type != "cuda":
        raise ValueError(f"{name}: At must be a CUDA tensor")
    if At.dtype not in _build.SUFFIX:
        raise TypeError(f"{name}: float32 or float64 expected, got {At.dtype}")
    if At.dim() != 3 or At.shape[0] != At.shape[1] or At.shape[0] < 1 or At.shape[2] < 1:
        raise ValueError(f"{name}: (n, n, B) operand with n, B >= 1 expected, got {tuple(At.shape)}")
    if not At.is_contiguous():
        raise ValueError(f"{name}: contiguous operand expected")
    _build.refuse_tangents(name, (At,), "jacobi.jacobi_eigh carries the tangent rule")


def jacobi_eigh_lanes(At: torch.Tensor, sweeps: int):
    """Launch kernel 4 on ``At`` (n, n, B), a CUDA tensor of even
    n <= 32; returns ``(w (n, B), V (n, n, B))``, unsorted."""
    _check("jacobi_eigh_lanes", At)
    n, _, B = At.shape
    if n % 2 or n > NARROW_MAX:
        # the round-robin schedule pairs rows; one row per thread of a warp
        raise ValueError(f"jacobi_eigh_lanes: the kernel takes even n <= {NARROW_MAX} (other widths: "
                         f"jacobi_eigh_lanes_wide), got {tuple(At.shape)}")
    w = torch.empty((n, B), dtype=At.dtype, device=At.device)
    V = torch.empty_like(At)
    _build.launch("jacobi_eigh", At.dtype, At.device, At.data_ptr(), w.data_ptr(), V.data_ptr(), n, B, sweeps)
    return w, V


_slot_tables: dict = {}


def slot_table(n: int, device) -> torch.Tensor:
    """The round-robin schedule of ``jacobi._round_robin_schedule`` as the
    wide kernel's slot table: (rounds, (n+1)/2, 2) int32 on ``device``,
    each slot a pair (p, q), and for odd n one slot (idle row, -1) per
    round.  Read by the kernel's general body; its register body computes
    the same schedule in closed form.  Cached per (n, device)."""
    from .jacobi import _round_robin_schedule

    key = (n, str(device))
    table = _slot_tables.get(key)
    if table is None:
        p, q = _round_robin_schedule(n)
        slots = np.stack([p, q], axis=-1)
        if n % 2:
            idle = [np.setdiff1d(np.arange(n), np.concatenate([pr, qr]))[0] for pr, qr in zip(p, q)]
            slots = np.concatenate([slots, np.stack([idle, np.full(len(idle), -1)], axis=-1)[:, None]], axis=1)
        table = torch.as_tensor(slots.reshape(-1, (n + 1) // 2, 2), dtype=torch.int32).to(device)
        _slot_tables[key] = table
    return table


def jacobi_eigh_lanes_wide(At: torch.Tensor, sweeps: int, workspace: bool = False):
    """Launch kernel 5 on ``At`` (n, n, B), a CUDA tensor, any n >= 1;
    returns ``(w (n, B), V (n, n, B))``, unsorted.  A device workspace
    holds A and V where shared memory cannot, or always with
    ``workspace=True`` (the checks' way to run the workspace body)."""
    _check("jacobi_eigh_lanes_wide", At)
    n, _, B = At.shape
    w = torch.empty((n, B), dtype=At.dtype, device=At.device)
    V = torch.empty_like(At)
    slots = slot_table(n, At.device)
    nbytes = (_build.entry("jacobi_eigh_wide", At.dtype, "workspace")(n, B)
              or (B * 2 * n * n * At.element_size() if workspace else 0))
    ws = torch.empty(nbytes // At.element_size(), dtype=At.dtype, device=At.device) if nbytes else None
    _build.launch("jacobi_eigh_wide", At.dtype, At.device, At.data_ptr(), w.data_ptr(), V.data_ptr(),
                  slots.data_ptr(), n, B, slots.shape[0], sweeps, None if ws is None else ws.data_ptr())
    return w, V
