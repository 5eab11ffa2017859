"""Nakajima-Tanaka (TMS/IMS) intensity corrections.

Counterpart of ``pythonic_disort_tpu/models/disort/nt.py`` (capability
parity with reference ``pydisort.py:375-698``): the delta-M solution's
intensity is corrected by (a) TMS, replacing the truncated single-scatter
contribution with the exact one computed from the full phase function,
accumulated across layers, and (b) IMS, removing the secondary-scattering
overshoot around the beam for downward directions.  Fluxes are never
corrected (the delta-M fluxes are already accurate).

The functions take a single-column solution (no batch axis).
"""

from __future__ import annotations

import math

import torch

from ...ops.legendre import legendre_series
from . import eval as ev
from .closures import Probes, u_closure
from .types import DisortSolution


def _nu(mu, phi, mu_p, phi_p):
    """cos of scattering angle; (len(mu), len(phi))."""
    s = torch.sqrt(1.0 - mu**2)
    s_p = torch.sqrt(1.0 - mu_p**2)
    return mu_p * mu[:, None] + s_p * s[:, None] * torch.cos(phi_p - phi)[None, :]


def nt_correction(sol: DisortSolution, tau, phi, antiderivative: bool = False):
    """TMS + IMS correction to the intensity; (2N, Ntau, Nphi), pre-rescale."""
    cfg = sol.config
    N, L = cfg.n, cfg.nlayers
    tau = torch.atleast_1d(tau)
    phi = torch.atleast_1d(phi)
    dtype, device = tau.dtype, tau.device

    mu_pos = sol.mu_arr_pos
    M_inv = 1.0 / mu_pos
    mu_arr = torch.cat([mu_pos, -mu_pos])
    mu0, phi0 = sol.mu0, sol.phi0
    I0_div_4pi = sol.I0 / (4.0 * math.pi)

    batch = ev._lift(sol)
    l = ev._layer_index(batch, tau[None])
    st = ev._scaled_tau(batch, tau[None], l)[0]
    l = l[0]
    tau_w0 = sol.scaled_tau_with_0
    st_bot = tau_w0[1:][l]
    st_top = tau_w0[l]
    scaled_thickness = tau_w0[1:] - tau_w0[:-1]            # (L,)

    # ---- TMS (reference pydisort.py:409-597) ----
    nu = _nu(mu_arr, phi, -mu0, phi0)                      # (2N, Nphi)
    # exact and truncated phase functions per layer at the beam angles
    p_true = legendre_series(sol.weighted_leg_all, nu)     # (L, 2N, Nphi)
    p_trun = legendre_series(sol.weighted_scaled_leg, nu)  # (L, 2N, Nphi)
    mathscr_B_layers = (
        (sol.scaled_omega_arr * I0_div_4pi)[:, None, None]
        * (mu0 / (mu0 + mu_arr))[None, :, None]
        * (p_true / (1.0 - sol.f_arr)[:, None, None] - p_trun)
    )                                                       # (L, 2N, Nphi)
    mathscr_B = mathscr_B_layers[l]                         # (Ntau, 2N, Nphi)

    scale_l = sol.scale_tau[l]
    exp_pos = torch.exp((st - st_bot)[None, :] * M_inv[:, None] - st_bot[None, :] / mu0)
    exp_neg = torch.exp((st_top - st)[None, :] * M_inv[:, None] - st_top[None, :] / mu0)
    if antiderivative:
        base = torch.exp(-st / mu0) / (-scale_l / mu0)
        tms_pos = base[None, :] - exp_pos / (scale_l[None, :] * M_inv[:, None])
        tms_neg = base[None, :] + exp_neg / (scale_l[None, :] * M_inv[:, None])
    else:
        base = torch.exp(-st / mu0)
        tms_pos = base[None, :] - exp_pos
        tms_neg = base[None, :] - exp_neg

    tms_fac = torch.cat([tms_pos, tms_neg], dim=0)          # (2N, Ntau)
    solution = mathscr_B.permute(1, 0, 2) * tms_fac[:, :, None]

    if L > 1:
        # Cross-layer accumulation (reference :493-591).  The reference
        # forms cumulative decay products and divides partial sums by
        # them; in float32 the product exp(sum log_decay) underflows to 0
        # for near-horizon streams (M_inv ~ 50 x layer thickness), turning
        # the division into 0/0 = NaN.  Instead form the pairwise
        # exponents CL_j - CL_l directly: every exponent is <= 0 by
        # construction, so the terms underflow harmlessly to 0.  Costs an
        # (N, L, L) tensor per solve.
        mu0_inv = 1.0 / mu0
        front = tau_w0[:-1]
        back = tau_w0[1:]
        exp_front_mu0 = torch.cat(
            [torch.ones((1,), dtype=dtype, device=device), torch.exp(-front[1:] * mu0_inv)])   # (L,)
        Bpos = mathscr_B_layers[:, :N, :]                   # (L, N, Nphi)
        Bneg = mathscr_B_layers[:, N:, :]

        log_decay = -scaled_thickness[None, :] * M_inv[:, None]   # (N, L)
        CL = torch.cat(
            [torch.zeros((N, 1), dtype=dtype, device=device), torch.cumsum(log_decay, dim=1)],
            dim=1)                                          # (N, L+1)
        neg_cap = torch.full((), -88.0, dtype=dtype, device=device)   # exp(-88) ~ f32 tiny
        if antiderivative:
            integration_factor = mu_pos[:, None] / sol.scale_tau[None, :]
        jj = torch.arange(L, device=device)

        # POS: contributions from layers below
        # R_pos[k, l] = sum_{j >= l+1} term_j exp(CL_j - CL_{l+1})
        thick_pos = scaled_thickness[None, :] * (M_inv + mu0_inv)[:, None]
        em1_pos = -torch.expm1(-thick_pos)
        if antiderivative:
            em1_pos = integration_factor * em1_pos
        layer_term_pos = em1_pos * exp_front_mu0[None, :]
        Epos = CL[:, None, :L] - CL[:, 1:, None]            # (N, l, j)
        mask_pos = (jj[None, :] >= jj[:, None] + 1)[None]   # (1, l, j)
        Rpos = torch.einsum(
            "klj,kj->kl", torch.exp(torch.where(mask_pos, Epos, neg_cap)) * mask_pos.to(dtype),
            layer_term_pos)                                 # (N, L)
        expfac_pos = torch.exp(M_inv[:, None] * (st - back[l])[None, :])
        addition_pos = (Rpos[:, l] * expfac_pos)[:, :, None] * Bpos[l].permute(1, 0, 2)

        # NEG: contributions from layers above
        # R_neg[k, l] = sum_{j <= l-1} term_j exp(CL_l - CL_{j+1})
        thick_neg = scaled_thickness[None, :] * (M_inv - mu0_inv)[:, None]
        exp_x1 = torch.exp(-back * mu0_inv)[None, :]
        exp_x0 = torch.exp(log_decay) * exp_front_mu0[None, :]
        em1_neg = torch.expm1(-thick_neg.abs())
        layer_term_neg = torch.where(thick_neg >= 0, -em1_neg * exp_x1, em1_neg * exp_x0)
        if antiderivative:
            layer_term_neg = -integration_factor * layer_term_neg
        Eneg = CL[:, :L, None] - CL[:, None, 1:]            # (N, l, j)
        mask_neg = (jj[None, :] <= jj[:, None] - 1)[None]
        Rneg = torch.einsum(
            "klj,kj->kl", torch.exp(torch.where(mask_neg, Eneg, neg_cap)) * mask_neg.to(dtype),
            layer_term_neg)
        expfac_neg = torch.exp(M_inv[:, None] * (front[l] - st)[None, :])
        addition_neg = (Rneg[:, l] * expfac_neg)[:, :, None] * Bneg[l].permute(1, 0, 2)

        solution = solution + torch.cat([addition_pos, addition_neg], dim=0)

    # ---- IMS (reference pydisort.py:599-639) ----
    sum1 = torch.sum(sol.omega_arr * sol.tau_arr)
    omega_avg = sum1 / torch.sum(sol.tau_arr)
    sum2 = torch.sum(sol.f_arr * sol.omega_arr * sol.tau_arr)
    f_avg = sum2 / sum1
    two_ell_p1 = 2.0 * torch.arange(cfg.nleg_all, dtype=dtype, device=device) + 1.0
    leg_all = sol.weighted_leg_all / two_ell_p1[None, :]
    residue = torch.cat([sol.f_arr[:, None].expand(L, cfg.nleg), leg_all[:, cfg.nleg:]], dim=1)
    residue_avg = torch.sum(residue * (sol.omega_arr * sol.tau_arr)[:, None], dim=0) / sum2
    scaled_mu0 = mu0 / (1.0 - omega_avg * f_avg)

    nu_neg = _nu(-mu_pos, phi, -mu0, phi0)                  # (N, Nphi)
    x = M_inv - 1.0 / scaled_mu0
    if antiderivative:
        chi = (
            (scaled_mu0 - x[:, None] * scaled_mu0 * (scaled_mu0 + tau)[None, :])
            * torch.exp(-tau / scaled_mu0)[None, :]
            - mu_pos[:, None] * torch.exp(-tau[None, :] * M_inv[:, None])
        ) / (mu_pos * scaled_mu0 * x**2)[:, None]
    else:
        chi = (
            (tau[None, :] - 1.0 / x[:, None]) * torch.exp(-tau / scaled_mu0)[None, :]
            + torch.exp(-tau[None, :] * M_inv[:, None]) / x[:, None]
        ) / (mu_pos * scaled_mu0 * x)[:, None]

    ims_phase = legendre_series(two_ell_p1 * (2.0 * residue_avg - residue_avg**2), nu_neg)   # (N, Nphi)
    ims = (
        I0_div_4pi * (omega_avg * f_avg) ** 2 / (1.0 - omega_avg * f_avg) * ims_phase
    )[:, None, :] * chi[:, :, None]                         # (N, Ntau, Nphi)

    return torch.cat([solution[:N], solution[N:] + ims], dim=0)


def u_corrected(sol: DisortSolution, tau, phi, antiderivative: bool = False,
                return_fourier_error: bool = False):
    """`eval.u` plus the TMS/IMS correction; same returns as `eval.u`."""
    corr = sol.rescale_factor * nt_correction(sol, tau, phi, antiderivative)
    if return_fourier_error:
        base, ferr = ev.u(sol, tau, phi, antiderivative, True)
        return base + corr, ferr
    return ev.u(sol, tau, phi, antiderivative) + corr


def make_corrected_u(sol: DisortSolution, probes: Probes | None = None):
    """Closure: NT-corrected intensity matching the reference's
    ``u_corrected`` (reference ``pydisort.py:643-698``)."""
    return u_closure(sol, probes or Probes(sol), u_corrected)
