"""Legendre-function building blocks.

Counterpart of ``pythonic_disort_tpu/ops/legendre.py``.

``lam[m, l, i] = sqrt((l-m)!/(l+m)!) P_l^m(x_i)`` without the
Condon-Shortley phase (it cancels in the products ``lam(x_i) lam(x_j)``
the scattering kernels use); entries with ``l < m`` are exactly zero.
`normalized_assoc_legendre` evaluates the table on the device of ``x``
(the single-column solve calls it at the nodes and at ``-mu0`` together);
`normalized_assoc_legendre_host` is its NumPy twin for points known when
a problem is built.  `legendre_series_bcast` evaluates ``sum_l c_l P_l(x)``
by Clenshaw's recurrence, a series per batch element; `legendre_series`
every series at every point.

On the card a series is one launch of the CUDA kernel
``csrc/legendre_series.cu`` (`legendre_series_rows`), which takes a call
reduced to R rows of coefficients and Q points a row (`row_operands`).
Every other call, and any call that takes a gradient or carries a
forward-mode tangent, runs the plain loop (`_clenshaw`), one step of five
tensor operations a moment; `legendre_series_rows_plain` is the kernel's
function in that loop.  Both round each operation as the loop does, so the
kernel's output is the loop's, bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.profiling import count
from . import _build


def _seed_log_coeffs(nmodes: int) -> np.ndarray:
    """log of |lam_m^m| prefactors: sqrt(prod_{k=1..m} (2k-1)/(2k))."""
    m = np.arange(nmodes)
    with np.errstate(divide="ignore"):
        ratios = np.concatenate([[0.0], np.log(2.0 * m[1:] - 1.0) - np.log(2.0 * m[1:])])
    return 0.5 * np.cumsum(ratios)


def normalized_assoc_legendre_host(nmodes: int, ndeg: int, x) -> np.ndarray:
    """Table ``lam`` of shape (nmodes, ndeg, npts), float64.

    Degree-upward recurrence
    ``sqrt((l+1)^2 - m^2) lam_{l+1} = (2l+1) x lam_l - sqrt(l^2 - m^2) lam_{l-1}``
    seeded at ``lam_m^m(x) = sqrt(prod_{k<=m} (2k-1)/(2k)) (1-x^2)^{m/2}``.
    """
    x = np.asarray(x, np.float64)
    npts = x.shape[0]
    ms = np.arange(nmodes, dtype=np.float64)[:, None]
    log_c = _seed_log_coeffs(nmodes)[:, None]
    one_minus_x2 = np.maximum(1.0 - x[None, :] ** 2, 0.0)
    safe = np.where(one_minus_x2 > 0.0, one_minus_x2, 1.0)
    seeds = np.exp(log_c + 0.5 * ms * np.log(safe))
    seeds = np.where((one_minus_x2 > 0.0) | (ms == 0), seeds, 0.0)

    out = np.zeros((nmodes, ndeg, npts))
    prev = np.zeros((nmodes, npts))
    prev2 = np.zeros((nmodes, npts))
    for ell in range(ndeg):
        denom = np.sqrt(np.maximum(float(ell) ** 2 - ms**2, 0.0))
        safe_denom = np.where(denom > 0.0, denom, 1.0)
        rec = (
            (2.0 * ell - 1.0) * x[None, :] * prev
            - np.sqrt(np.maximum((ell - 1.0) ** 2 - ms**2, 0.0)) * prev2
        ) / safe_denom
        cur = np.where(ms == ell, seeds, np.where(ms < ell, rec, 0.0))
        out[:, ell] = cur
        prev2, prev = prev, cur
    return out


@functools.lru_cache(maxsize=None)
def _recurrence_system(nmodes: int, ndeg: int, dtype, device):
    """The upward recurrence as a unit lower-triangular system per mode,
    ``(C0 + x C1) lam = e_m seed``, rows of degree l: ``lam_l - a_l x
    lam_{l-1} + b_l lam_{l-2} = 0`` for l > m with ``a_l = (2l-1) / d_l``,
    ``b_l = sqrt((l-1)^2 - m^2) / d_l``, ``d_l = sqrt(l^2 - m^2)``; ``lam_m``
    the seed; ``lam_l = 0`` for l < m.  Returns ``C0``, ``C1`` (nmodes, 1,
    ndeg, ndeg), the seed rows' mask (nmodes, 1, ndeg), the log seed
    coefficients (nmodes, 1) and the modes (nmodes, 1)."""
    ms = np.arange(nmodes, dtype=np.float64)[:, None]
    ell = np.arange(ndeg, dtype=np.float64)[None, :]
    denom = np.sqrt(np.maximum(ell**2 - ms**2, 0.0))
    safe_denom = np.where(denom > 0.0, denom, 1.0)
    above = ms < ell
    a = np.where(above, (2.0 * ell - 1.0) / safe_denom, 0.0)                # (nmodes, ndeg)
    b = np.where(above, np.sqrt(np.maximum((ell - 1.0) ** 2 - ms**2, 0.0)) / safe_denom, 0.0)
    C0 = np.broadcast_to(np.eye(ndeg), (nmodes, ndeg, ndeg)).copy()
    C1 = np.zeros((nmodes, ndeg, ndeg))
    rows = np.arange(ndeg)
    C1[:, rows[1:], rows[1:] - 1] = -a[:, 1:]
    C0[:, rows[2:], rows[2:] - 2] = b[:, 2:]
    const = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return (const(C0[:, None]), const(C1[:, None]), const(ms == ell)[:, None],
            const(_seed_log_coeffs(nmodes)[:, None]), const(ms))


def normalized_assoc_legendre(nmodes: int, ndeg: int, x: torch.Tensor) -> torch.Tensor:
    """Table ``lam`` of shape (nmodes, ndeg, npts) on the device of ``x``.

    The same recurrence and seeds as `normalized_assoc_legendre_host`;
    ``x``: (npts,) points in [-1, 1].  The recurrence runs as one batched
    unit lower-triangular solve of its banded system (`_recurrence_system`),
    a few launches on the card where a loop over the degrees took seven a
    degree; it differs from the loop by roundoff and carries gradients and
    forward-mode tangents.
    """
    C0, C1, is_seed, log_c, ms = _recurrence_system(nmodes, ndeg, x.dtype, x.device)
    one_minus_x2 = torch.clamp(1.0 - x[None, :] ** 2, min=0.0)
    positive = one_minus_x2 > 0.0
    safe = torch.where(positive, one_minus_x2, torch.ones_like(one_minus_x2))
    seeds = torch.exp(log_c + 0.5 * ms * torch.log(safe))
    seeds = torch.where(positive | (ms == 0), seeds, torch.zeros_like(seeds))       # (nmodes, npts)

    system = torch.addcmul(C0, x[None, :, None, None], C1)                           # (nmodes, npts, ndeg, ndeg)
    rhs = (is_seed * seeds[:, :, None])[..., None]                                    # (nmodes, npts, ndeg, 1)
    lam = torch.linalg.solve_triangular(system, rhs, upper=False, unitriangular=True)
    return lam[..., 0].transpose(1, 2)


def legendre_series(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``f_b(x) = sum_l coeffs[b, l] P_l(x)`` for every series b and point x.

    ``coeffs``: (..., ndeg); ``x``: any shape.  Returns
    ``coeffs.shape[:-1] + x.shape``.
    """
    lead = coeffs.shape[:-1]
    return legendre_series_bcast(coeffs.reshape(lead + (1,) * x.dim() + coeffs.shape[-1:]), x)


def legendre_series_bcast(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_l coeffs[..., l] P_l(x)`` by Clenshaw's recurrence, with
    ``coeffs[..., l]`` broadcast against ``x``: a series per batch element,
    e.g. coeffs (S, L, 1, 1, ndeg) and x (S, 1, K, P) give (S, L, K, P).
    On the card one launch of `legendre_series_rows` where the call takes
    the row form (`row_operands`) and `_loop_only` does not hold; otherwise
    the plain loop.  Counts its ``ndeg`` Clenshaw steps as
    ``legendre_terms`` while a profiler runs, on either route."""
    ndeg = coeffs.shape[-1]
    count("legendre_terms", ndeg)
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    if _on_card(coeffs, x) and not _loop_only(coeffs, x):
        operands = row_operands(coeffs, x, shape)
        if operands is not None:
            return legendre_series_rows(*operands).reshape(shape)
    return _clenshaw(coeffs, x, shape)


def _clenshaw(coeffs: torch.Tensor, x: torch.Tensor, shape) -> torch.Tensor:
    """The plain loop: one step of five tensor operations a moment, from the
    top degree down; ``shape`` is the broadcast output shape."""
    b1 = torch.zeros(shape, dtype=x.dtype, device=x.device)
    b2 = torch.zeros_like(b1)
    for ell in range(coeffs.shape[-1] - 1, -1, -1):
        alpha = (2.0 * ell + 1.0) / (ell + 1.0)
        beta = (ell + 1.0) / (ell + 2.0)
        b1, b2 = coeffs[..., ell] + alpha * x * b1 - beta * b2, b1
    return b1


def _on_card(coeffs: torch.Tensor, x: torch.Tensor) -> bool:
    return x.is_cuda and coeffs.device == x.device


def _loop_only(coeffs: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether a call needs the plain loop on any device: operands of two
    dtypes or of one the kernel does not take (float32, float64), a
    gradient (grad mode on and an operand requiring one) or a forward-mode
    tangent (``_build.has_tangent``): the kernel carries neither."""
    grad = torch.is_grad_enabled() and (coeffs.requires_grad or x.requires_grad)
    return (coeffs.dtype != x.dtype or x.dtype not in _build.SUFFIX or grad
            or _build.has_tangent(coeffs) or _build.has_tangent(x))


def row_operands(coeffs: torch.Tensor, x: torch.Tensor, shape):
    """The call as the kernel takes it: ``(coeffs (R, ndeg), x (R, Q))``,
    contiguous, where the coefficients' batch shape, left-padded with ones
    to the rank of the output ``shape``, is ``shape[:k] + (1,) * t``: R =
    prod(shape[:k]) rows of their own coefficients and Q = prod(shape[k:])
    points a row, ``x`` broadcast to ``shape`` (a copy no larger than the
    output).  None where coefficients are shared along a leading axis or a
    size is 0 or does not fit the kernel's 32-bit sizes."""
    ndeg = coeffs.shape[-1]
    batch = (1,) * (len(shape) - coeffs.dim() + 1) + tuple(coeffs.shape[:-1])
    k = len(batch)
    while k and batch[k - 1] == 1:
        k -= 1
    if batch[:k] != tuple(shape[:k]):
        return None
    R, Q = math.prod(shape[:k]), math.prod(shape[k:])
    if min(R, Q, ndeg) < 1 or max(R, Q, ndeg) >= 2**31:
        return None
    return (coeffs.reshape(R, ndeg).contiguous(),
            x.broadcast_to(shape).reshape(R, Q).contiguous())


def legendre_series_rows_plain(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: ``out[r, q] =
    sum_l coeffs[r, l] P_l(x[r, q])``, ``coeffs`` (R, ndeg), ``x`` (R, Q),
    by the plain loop's steps and roundings."""
    return _clenshaw(coeffs[:, None, :], x, x.shape)


def _check(coeffs: torch.Tensor, x: torch.Tensor) -> None:
    name = "legendre_series_rows"
    if not _on_card(coeffs, x):
        raise ValueError(f"{name}: coeffs and x must be CUDA tensors on one device")
    if x.dtype not in _build.SUFFIX or coeffs.dtype != x.dtype:
        raise TypeError(f"{name}: float32 or float64 expected, got {coeffs.dtype}/{x.dtype}")
    if coeffs.dim() != 2 or x.dim() != 2 or coeffs.shape[0] != x.shape[0] or 0 in coeffs.shape + x.shape:
        raise ValueError(f"{name}: coeffs (R, ndeg) and x (R, Q), R, Q, ndeg >= 1, expected, got "
                         f"{tuple(coeffs.shape)}, {tuple(x.shape)}")
    if max(coeffs.shape + x.shape) >= 2**31:
        raise ValueError(f"{name}: sizes below 2**31 expected, got {tuple(coeffs.shape)}, {tuple(x.shape)}")
    if not (coeffs.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: contiguous operands expected")
    if torch.is_grad_enabled() and (coeffs.requires_grad or x.requires_grad):
        raise NotImplementedError(f"{name}: the kernel takes no gradient; legendre_series_bcast routes "
                                  "operands that require one through the plain loop")
    _build.refuse_tangents(name, (coeffs, x), "legendre_series_bcast routes dual operands through the plain loop")


def legendre_series_rows(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[r, q] = sum_l coeffs[r, l] P_l(x[r, q])`` for ``coeffs``
    (R, ndeg) and ``x`` (R, Q).  CPU tensors take
    `legendre_series_rows_plain`; CUDA tensors launch the kernel (counted
    under ``legendre_series``) or raise."""
    if not (coeffs.is_cuda or x.is_cuda):
        return legendre_series_rows_plain(coeffs, x)
    _check(coeffs, x)
    out = torch.empty_like(x)
    _build.launch("legendre_series", x.dtype, x.device, coeffs.data_ptr(), x.data_ptr(), out.data_ptr(),
                  x.shape[0], x.shape[1], coeffs.shape[1])
    return out
