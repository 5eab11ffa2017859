"""Symmetrized discrete-ordinates eigensolver.

Counterpart of ``pythonic_disort_tpu/ops/eig.py`` (``disort_eigh_lanes``
for the batched solve, ``disort_eigh`` for the single-column solve).
With ``c = diag(sqrt(w mu))`` and ``rho = diag(sqrt(w / mu))`` the two
half-size operators become symmetric (Stamnes & Swanson 1981)::

    At = rho ((D+ - D-) - W^-1) rho,    Bt = rho ((D+ + D-) - W^-1) rho

and the eigen stage (`cuda_eig.eig_stage_lanes`) diagonalizes ``At Bt``
through one Cholesky congruence.  This module builds At/Bt and applies
the diagonal ``c`` scalings that take the stage's outputs back to the
physical eigenbasis.  `disort_eigh` is the padded (..., N, N) interface:
it flattens the leading axes into lanes around `disort_eigh_lanes`.

Kernel 1 takes even n <= 32, the sizes of the TPU kernel.  At odd n and
n > 32, under a gradient (grad mode on and At or Bt requiring one) and
under forward mode (At or Bt carrying a ``torch.autograd.forward_ad``
tangent, which ``requires_grad`` does not show), the stage is
`_eig_stage_ad` instead: the Cholesky factor, the congruence and the
back-transforms in differentiable tensor code around `jacobi.jacobi_eigh`
(CUDA kernel 4 or 5 on the card), which carries the eigh derivative rules
of both modes.  It is the counterpart of the JAX package's
``_eig_stage_lanes_jnp`` (its route at n > 32) and ``_eig_stage_ad`` (the
tangent path of its fused stage).  The route is chosen by n on either
device; only the innermost Jacobi depends on it.
"""

from __future__ import annotations

import torch

from ._build import has_tangent
from .cuda_eig import STAGE_MAX, eig_stage_lanes
from .jacobi import jacobi_eigh


def _eig_stage_ad(At: torch.Tensor, Bt: torch.Tensor):
    """Differentiable eigen stage on padded (..., n, n) ``At``, ``Bt``.

    Returns the raw ``(K (..., n), V, Yr, Pr, Qr (..., n, n))`` of
    `cuda_eig.eig_stage_lanes`, eigen columns unsorted.  The Cholesky
    factor and the triangular solve take PyTorch's native backward;
    ``cholesky_ex`` does not synchronize the host to check the factor.
    """
    L = torch.linalg.cholesky_ex(-Bt)[0]                        # -Bt = L L^T
    M = L.mT @ (-At) @ L                                        # L^T (-At) L
    K2, Z = jacobi_eigh(M, sort=False)
    K = torch.sqrt(torch.clamp(K2, min=torch.finfo(At.dtype).tiny))
    V = torch.linalg.solve_triangular(L.mT, Z, upper=True)      # L^-T Z
    LZ = L @ Z
    Yr = -LZ / K[..., None, :]
    Pr = LZ.mT
    Qr = -K[..., :, None] * V.mT
    return K, V, Yr, Pr, Qr


def _eig_stage(At: torch.Tensor, Bt: torch.Tensor):
    """The eigen stage on lanes operands (n, n, B): kernel 1 at even
    n <= 32, or `_eig_stage_ad` in the padded layout at any other n and
    when a gradient or a forward-mode tangent is taken."""
    n = At.shape[0]
    grad = torch.is_grad_enabled() and (At.requires_grad or Bt.requires_grad)
    if grad or has_tangent(At) or has_tangent(Bt) or n % 2 or n > STAGE_MAX:
        K, *mats = _eig_stage_ad(At.permute(2, 0, 1), Bt.permute(2, 0, 1))
        return (K.T, *(x.permute(1, 2, 0) for x in mats))
    return eig_stage_lanes(At.contiguous(), Bt.contiguous())


def disort_eigh_lanes(Dp_l: torch.Tensor, Dm_l: torch.Tensor, mu: torch.Tensor,
                      w: torch.Tensor):
    """Eigenpairs of the discrete-ordinates system on lanes operands.

    ``Dp_l``, ``Dm_l``: (N, N, B) symmetric kernels (omega/2-weighted);
    ``mu``, ``w``: (N,).  Returns ``(K (N, B), X, Y, P, Q (N, N, B))``:
    the columns of X are eigenvectors of ``(alpha - beta)(alpha + beta)``,
    ``Y = (alpha + beta) X / K``, ``P = X^-1`` and ``Q = Y^-1``.
    """
    rho = torch.sqrt(w / mu)
    c = torch.sqrt(w * mu)
    outer_rho = (rho[:, None] * rho[None, :])[:, :, None]
    inv_mu_diag = torch.diag(1.0 / mu)[:, :, None]

    At = outer_rho * (Dp_l - Dm_l) - inv_mu_diag
    Bt = outer_rho * (Dp_l + Dm_l) - inv_mu_diag

    K, V, Yr, Pr, Qr = _eig_stage(At, Bt)
    X = V / c[:, None, None]
    Y = Yr / c[:, None, None]
    P = Pr * c[None, :, None]
    Q = Qr * c[None, :, None]
    return K, X, Y, P, Q


def disort_eigh(Dp: torch.Tensor, Dm: torch.Tensor, mu: torch.Tensor, w: torch.Tensor):
    """`disort_eigh_lanes` on padded operands.

    ``Dp``, ``Dm``: (..., N, N).  Returns ``K (..., N)`` and
    ``X, Y, P, Q (..., N, N)``; the order of the eigen columns is
    unspecified (the boundary-value coefficients adapt to it).
    """
    N = Dp.shape[-1]
    batch_shape = tuple(Dp.shape[:-2])
    to_lanes = lambda x: x.reshape(-1, N, N).permute(1, 2, 0)
    K, *mats = disort_eigh_lanes(to_lanes(Dp), to_lanes(Dm), mu, w)
    unl = lambda x: x.permute(2, 0, 1).reshape(batch_shape + (N, N))
    return (K.T.reshape(batch_shape + (N,)), *(unl(x) for x in mats))
