"""Nakajima-Tanaka (TMS/IMS) intensity corrections.

Counterpart of ``pythonic_disort_tpu/models/disort/nt.py`` (capability
parity with reference ``pydisort.py:375-698``): the delta-M solution's
intensity is corrected by (a) TMS, replacing the truncated single-scatter
contribution with the exact one computed from the full phase function,
accumulated across layers, and (b) IMS, removing the secondary-scattering
overshoot around the beam for downward directions.  Fluxes are never
corrected (the delta-M fluxes are already accurate).

The functions take a batched solution (leading S on every tensor, probes
(S, Ntau), azimuths (S, Nphi)) or a single-column one, evaluated as a
batch of one, as the evaluators of `eval` do.
"""

from __future__ import annotations

import math

import torch

from ...ops.legendre import legendre_series_bcast
from ...utils.profiling import span
from . import eval as ev
from .closures import Probes, u_closure
from .types import DisortSolution


def _nu(mu, phi, mu_p, phi_p):
    """cos of the scattering angle per solve; (S, len(mu), len(phi)).

    ``mu`` (S, K), ``phi`` (S, P), ``mu_p`` and ``phi_p`` (S,).
    """
    s = torch.sqrt(1.0 - mu**2)
    s_p = torch.sqrt(1.0 - mu_p**2)
    return (mu_p[:, None, None] * mu[:, :, None]
            + s_p[:, None, None] * s[:, :, None] * torch.cos(phi_p[:, None] - phi)[:, None, :])


@ev._either
def nt_correction(sol: DisortSolution, tau, phi, antiderivative: bool = False):
    """TMS + IMS correction to the intensity; (S, 2N, Ntau, Nphi), pre-rescale.

    Batched like the evaluators of `eval`: every reduction and layer gather
    is per solve.
    """
    cfg = sol.config
    N, L = cfg.n, cfg.nlayers
    dtype, device = tau.dtype, tau.device
    S = tau.shape[0]

    mu_pos = sol.mu_arr_pos                                  # (S, N)
    M_inv = 1.0 / mu_pos
    mu_arr = torch.cat([mu_pos, -mu_pos], dim=1)             # (S, 2N)
    mu0, phi0 = sol.mu0, sol.phi0                            # (S,)
    mu0_t = mu0[:, None]
    I0_div_4pi = sol.I0 / (4.0 * math.pi)

    l = ev._layer_index(sol, tau)                            # (S, Ntau)
    st = ev._scaled_tau(sol, tau, l)
    tau_w0 = sol.scaled_tau_with_0                           # (S, L+1)
    front, back = tau_w0[:, :-1], tau_w0[:, 1:]              # (S, L)
    st_bot = ev._take(back, l)
    st_top = ev._take(front, l)
    scaled_thickness = back - front

    # IMS averages per solve (reference pydisort.py:599-639)
    omega_tau = sol.omega_arr * sol.tau_arr                  # (S, L)
    sum1 = omega_tau.sum(dim=-1)
    omega_avg = sum1 / sol.tau_arr.sum(dim=-1)
    sum2 = (sol.f_arr * omega_tau).sum(dim=-1)
    f_avg = sum2 / sum1
    two_ell_p1 = 2.0 * torch.arange(cfg.nleg_all, dtype=dtype, device=device) + 1.0
    leg_all = sol.weighted_leg_all / two_ell_p1
    residue = torch.cat([sol.f_arr[..., None].expand(S, L, cfg.nleg), leg_all[..., cfg.nleg:]], dim=-1)
    residue_avg = (residue * omega_tau[..., None]).sum(dim=-2) / sum2[:, None]   # (S, nleg_all)
    nu_neg = _nu(-mu_pos, phi, -mu0, phi0)                   # (S, N, Nphi)

    nu = _nu(mu_arr, phi, -mu0, phi0)[:, None]               # (S, 1, 2N, Nphi)
    with span("disort.eval.nt.series", device):
        # Three Legendre series, each one kernel launch on the card (the
        # plain loop on the CPU and under a gradient or a tangent): the IMS
        # residual phase function at the downward streams, then the TMS's
        # exact and truncated phase functions per layer, which broadcast
        # the one ``nu`` along the layers.
        ims_phase = legendre_series_bcast(
            (two_ell_p1 * (2.0 * residue_avg - residue_avg**2))[:, None, None, :], nu_neg)   # (S, N, Nphi)
        p_true = legendre_series_bcast(sol.weighted_leg_all[:, :, None, None, :], nu)    # (S, L, 2N, Nphi)
        p_trun = legendre_series_bcast(sol.weighted_scaled_leg[:, :, None, None, :], nu)

    # ---- TMS (reference pydisort.py:409-597) ----
    mathscr_B_layers = (
        (sol.scaled_omega_arr * I0_div_4pi[:, None])[:, :, None, None]
        * (mu0_t / (mu0_t + mu_arr))[:, None, :, None]
        * (p_true / (1.0 - sol.f_arr)[:, :, None, None] - p_trun)
    )                                                        # (S, L, 2N, Nphi)
    mathscr_B = ev._take(mathscr_B_layers, l)                # (S, Ntau, 2N, Nphi)

    scale_l = ev._take(sol.scale_tau, l)                     # (S, Ntau)
    Mi = M_inv[:, :, None]                                   # (S, N, 1)
    exp_pos = torch.exp((st - st_bot)[:, None] * Mi - (st_bot / mu0_t)[:, None])   # (S, N, Ntau)
    exp_neg = torch.exp((st_top - st)[:, None] * Mi - (st_top / mu0_t)[:, None])
    if antiderivative:
        base = (torch.exp(-st / mu0_t) / (-scale_l / mu0_t))[:, None]
        tms_pos = base - exp_pos / (scale_l[:, None] * Mi)
        tms_neg = base + exp_neg / (scale_l[:, None] * Mi)
    else:
        base = torch.exp(-st / mu0_t)[:, None]
        tms_pos = base - exp_pos
        tms_neg = base - exp_neg

    tms_fac = torch.cat([tms_pos, tms_neg], dim=1)           # (S, 2N, Ntau)
    solution = mathscr_B.permute(0, 2, 1, 3) * tms_fac[..., None]   # (S, 2N, Ntau, Nphi)

    if L > 1:
        with span("disort.eval.nt.layers", device):
            # Cross-layer accumulation (reference :493-591).  The reference
            # forms cumulative decay products and divides partial sums by
            # them; in float32 the product exp(sum log_decay) underflows to 0
            # for near-horizon streams (M_inv ~ 50 x layer thickness), turning
            # the division into 0/0 = NaN.  Instead form the pairwise
            # exponents CL_j - CL_l directly: every exponent is <= 0 by
            # construction, so the terms underflow harmlessly to 0.  Costs an
            # (S, N, L, L) tensor.
            mu0_inv = (1.0 / mu0)[:, None, None]                 # (S, 1, 1)
            exp_front_mu0 = torch.cat(
                [torch.ones((S, 1), dtype=dtype, device=device), torch.exp(-front[:, 1:] / mu0_t)], dim=1)   # (S, L)
            Bpos = mathscr_B_layers[:, :, :N]                    # (S, L, N, Nphi)
            Bneg = mathscr_B_layers[:, :, N:]

            log_decay = -scaled_thickness[:, None, :] * Mi       # (S, N, L)
            CL = torch.cat([torch.zeros((S, N, 1), dtype=dtype, device=device),
                            torch.cumsum(log_decay, dim=2)], dim=2)          # (S, N, L+1)
            neg_cap = torch.full((), -88.0, dtype=dtype, device=device)   # exp(-88) ~ f32 tiny
            if antiderivative:
                integration_factor = mu_pos[:, :, None] / sol.scale_tau[:, None, :]   # (S, N, L)
            jj = torch.arange(L, device=device)

            # POS: contributions from layers below
            # R_pos[k, l] = sum_{j >= l+1} term_j exp(CL_j - CL_{l+1})
            thick_pos = scaled_thickness[:, None, :] * (Mi + mu0_inv)
            em1_pos = -torch.expm1(-thick_pos)
            if antiderivative:
                em1_pos = integration_factor * em1_pos
            layer_term_pos = em1_pos * exp_front_mu0[:, None, :]
            Epos = CL[:, :, None, :L] - CL[:, :, 1:, None]       # (S, N, l, j)
            mask_pos = jj[None, :] >= jj[:, None] + 1            # (l, j)
            Rpos = torch.einsum(
                "sklj,skj->skl", torch.exp(torch.where(mask_pos, Epos, neg_cap)) * mask_pos.to(dtype),
                layer_term_pos)                                  # (S, N, L)
            expfac_pos = torch.exp(Mi * (st - ev._take(back, l))[:, None])            # (S, N, Ntau)
            addition_pos = ((ev._take(Rpos, l, dim=2) * expfac_pos)[..., None]
                            * ev._take(Bpos, l).permute(0, 2, 1, 3))

            # NEG: contributions from layers above
            # R_neg[k, l] = sum_{j <= l-1} term_j exp(CL_l - CL_{j+1})
            thick_neg = scaled_thickness[:, None, :] * (Mi - mu0_inv)
            exp_x1 = torch.exp(-back / mu0_t)[:, None, :]
            exp_x0 = torch.exp(log_decay) * exp_front_mu0[:, None, :]
            em1_neg = torch.expm1(-thick_neg.abs())
            layer_term_neg = torch.where(thick_neg >= 0, -em1_neg * exp_x1, em1_neg * exp_x0)
            if antiderivative:
                layer_term_neg = -integration_factor * layer_term_neg
            Eneg = CL[:, :, :L, None] - CL[:, :, None, 1:]       # (S, N, l, j)
            mask_neg = jj[None, :] <= jj[:, None] - 1
            Rneg = torch.einsum(
                "sklj,skj->skl", torch.exp(torch.where(mask_neg, Eneg, neg_cap)) * mask_neg.to(dtype),
                layer_term_neg)
            expfac_neg = torch.exp(Mi * (ev._take(front, l) - st)[:, None])
            addition_neg = ((ev._take(Rneg, l, dim=2) * expfac_neg)[..., None]
                            * ev._take(Bneg, l).permute(0, 2, 1, 3))

            solution = solution + torch.cat([addition_pos, addition_neg], dim=1)

    # ---- IMS (reference pydisort.py:599-639) ----
    scaled_mu0 = (mu0 / (1.0 - omega_avg * f_avg))[:, None]                      # (S, 1)
    x = M_inv - 1.0 / scaled_mu0                             # (S, N)
    t = tau[:, None, :]                                      # (S, 1, Ntau)
    sm0 = scaled_mu0[..., None]
    if antiderivative:
        chi = (
            (sm0 - x[..., None] * sm0 * (sm0 + t)) * torch.exp(-t / sm0)
            - mu_pos[..., None] * torch.exp(-t * Mi)
        ) / (mu_pos * scaled_mu0 * x**2)[..., None]
    else:
        chi = (
            (t - 1.0 / x[..., None]) * torch.exp(-t / sm0) + torch.exp(-t * Mi) / x[..., None]
        ) / (mu_pos * scaled_mu0 * x)[..., None]             # (S, N, Ntau)

    ofa = omega_avg * f_avg
    ims = ((I0_div_4pi * ofa**2 / (1.0 - ofa))[:, None, None] * ims_phase)[:, :, None, :] * chi[..., None]

    return torch.cat([solution[:, :N], solution[:, N:] + ims], dim=1)


@ev._either
def u_corrected(sol: DisortSolution, tau, phi, antiderivative: bool = False,
                return_fourier_error: bool = False):
    """`eval.u` plus the TMS/IMS correction; same returns as `eval.u`."""
    corr = sol.rescale_factor[:, None, None, None] * nt_correction(sol, tau, phi, antiderivative)
    if return_fourier_error:
        base, ferr = ev.u(sol, tau, phi, antiderivative, True)
        return base + corr, ferr
    return ev.u(sol, tau, phi, antiderivative) + corr


def make_corrected_u(sol: DisortSolution, probes: Probes | None = None):
    """Closure: NT-corrected intensity matching the reference's
    ``u_corrected`` (reference ``pydisort.py:643-698``)."""
    return u_closure(sol, probes or Probes(sol), u_corrected)
