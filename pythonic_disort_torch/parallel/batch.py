"""Batched (columns x bands) flux solves: the port's production entry points.

Counterpart of ``pythonic_disort_tpu/parallel/batch.py``
(``make_batched_problem``, ``fluxes_at``, ``solve_fluxes``).  The batch
axis is written out as the leading axis of every tensor.  Problems are
built on ``cuda`` unless the caller passes ``device="cpu"``; without a
card and without that request they raise rather than run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.disort import eval as ev
from ..models.disort.batch_solve import solve_batched
from ..models.disort.types import DisortConfig, DisortProblem
from ..ops.legendre import normalized_assoc_legendre_host


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU")
    return device


def make_batched_problem(
    config: DisortConfig,
    tau_arr,            # (B, L)
    omega_arr,          # (B, L)
    leg_coeffs_all,     # (B, L, nleg_all)
    mu0,                # (B,)
    I0,                 # (B,)
    phi0=None,          # (B,) or None -> zeros
    f_arr=None,         # (B, L) or None -> zeros
    b_pos=None,         # (B, N, NF) or None -> zeros
    b_neg=None,
    s_poly_coeffs=None,  # (B, L, Ns) or None
    bdrf_modes=None,     # (B, NB, N, N) or None
    bdrf_modes_mu0=None,
    dtype=torch.float32,
    device=None,         # default "cuda"
) -> DisortProblem:
    """Assemble a batched problem (leading axis = batch) on ``device``.

    The beam's Legendre basis at ``-mu0`` is tabulated on the host here
    (``lam_mu0``, (B, NF, NLeg)), so a mu0 that requires a gradient is
    refused.  A tensor argument is used as it is when its dtype and device
    match, so its graph reaches the solve (gradients w.r.t. omega, tau, ...).
    """
    device = _device(device)
    B, L = np.shape(tau_arr)
    N, NF = config.n, config.nfourier

    def _arr(x, shape=None):
        if x is None:
            return torch.zeros((B,) + shape, dtype=dtype, device=device)
        if isinstance(x, torch.Tensor):
            return x.to(dtype=dtype, device=device)
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    if isinstance(mu0, torch.Tensor):
        if mu0.requires_grad:
            raise NotImplementedError(
                "batched gradients with respect to mu0 are not ported (lam_mu0 is tabulated on the host; "
                "the single-column solve takes them): ROADMAP queue 1, item 8")
        mu0_host = mu0.detach().cpu().double().numpy()
    else:
        mu0_host = np.asarray(mu0, np.float64)
    lam_mu0 = np.transpose(
        normalized_assoc_legendre_host(NF, config.nleg, -mu0_host), (2, 0, 1))

    return DisortProblem(
        config=config,
        tau_arr=_arr(tau_arr),
        omega_arr=_arr(omega_arr),
        leg_coeffs_all=_arr(leg_coeffs_all),
        f_arr=_arr(f_arr, (L,)),
        mu0=_arr(mu0),
        I0=_arr(I0),
        phi0=_arr(phi0, ()),
        b_pos=_arr(b_pos, (N, NF)),
        b_neg=_arr(b_neg, (N, NF)),
        s_poly_coeffs=_arr(s_poly_coeffs, (L, max(config.nscoeffs, 1))),
        bdrf_modes=_arr(bdrf_modes, (max(config.nbdrf, 1), N, N)),
        bdrf_modes_mu0=_arr(bdrf_modes_mu0, (max(config.nbdrf, 1), N)),
        lam_mu0=_arr(lam_mu0),
    )


def fluxes_at(sol, tau):
    """(flux_up, flux_down_diffuse, flux_down_direct), each (B, Ntau).

    ``tau`` is best a tensor on the solution's device: an array is copied
    over first, and that copy synchronizes the stream.
    """
    tau = torch.as_tensor(tau, dtype=sol.tau_arr.dtype, device=sol.tau_arr.device)
    return ev.fluxes_all(sol, tau)


def solve_fluxes(problem: DisortProblem, tau_eval):
    """Batched solve + flux evaluation at ``tau_eval`` (B, Ntau), a tensor
    on the problem's device (see `fluxes_at`)."""
    _device(problem.tau_arr.device)
    return fluxes_at(solve_batched(problem), tau_eval)
