"""Flux evaluation over a batched `DisortSolution`.

Counterpart of ``pythonic_disort_tpu/models/disort/eval.py``
(``_layer_index``, ``_scaled_tau``, ``_exponent``, ``fluxes_all``), with
the batch written out: the solution's tensors carry a leading S and the
probe depths are (S, Ntau).  Outputs are in physical units (multiplied by
the solve's internal rescale factor).
"""

from __future__ import annotations

import math

import torch

from .types import DisortSolution


def _take(x: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """x[s, l[s, t], ...]: (S, L[, k]) gathered at (S, Ntau) layer indices."""
    if x.dim() == 2:
        return torch.gather(x, 1, l)
    return torch.gather(x, 1, l[..., None].expand(-1, -1, x.shape[-1]))


def _layer_index(sol: DisortSolution, tau: torch.Tensor) -> torch.Tensor:
    """Layer of each tau: tau in (tau_{l-1}, tau_l] -> l; (S, Ntau).

    A dense compare-and-count (``searchsorted(side="left")``), clipped to
    the last layer.
    """
    l = (sol.tau_arr[:, None, :] < tau[:, :, None]).sum(dim=-1)
    return l.clamp(0, sol.config.nlayers - 1)


def _scaled_tau(sol: DisortSolution, tau, l):
    """Delta-M re-scaling of user tau (reference _assemble...py:190-195)."""
    if not sol.config.has_deltam:
        return tau
    bot = _take(sol.scaled_tau_with_0[:, 1:], l)
    return bot - (_take(sol.tau_arr, l) - tau) * _take(sol.scale_tau, l)


def _exponent(sol: DisortSolution, l, scaled_tau, K):
    """Overflow-free homogeneous exponents, (S, Ntau, 2N), all <= 0.

    Negative-K columns anchor at the layer top, positive-K at the layer
    bottom (reference _assemble...py:197-203).  ``K``: (S, L, 2N).
    """
    N = sol.config.n
    top = _take(sol.scaled_tau_with_0[:, :-1], l)
    bot = _take(sol.scaled_tau_with_0[:, 1:], l)
    Kl = _take(K, l)
    return torch.cat(
        [Kl[..., :N] * (scaled_tau - top)[..., None],
         Kl[..., N:] * (scaled_tau - bot)[..., None]], dim=-1)


def fluxes_all(sol: DisortSolution, tau: torch.Tensor, antiderivative: bool = False):
    """``(flux_up, flux_down_diffuse, flux_down_direct)``, each (S, Ntau).

    Reads the per-layer flux tables (``fvec_*``, ``fb_*``) at each probe's
    layer.  Reference ``_assemble...py:446-613``, including the delta-M
    reclassification of the direct beam into the diffuse flux.
    """
    cfg = sol.config
    if cfg.has_iso:
        raise NotImplementedError(
            "isotropic internal sources are not ported yet: ROADMAP queue 1, module 4")
    l = _layer_index(sol, tau)
    st = _scaled_tau(sol, tau, l)
    K0 = sol.K[:, 0]                                           # (S, L, 2N)
    expo = torch.exp(_exponent(sol, l, st, K0))
    if antiderivative:
        expo = expo / (_take(sol.scale_tau, l)[..., None] * _take(K0, l))
    up = (_take(sol.fvec_up, l) * expo).sum(dim=-1)
    dn = (_take(sol.fvec_dn, l) * expo).sum(dim=-1)
    mu0 = sol.mu0[:, None]
    if cfg.has_beam:
        beam = torch.exp(-st / mu0)
        if antiderivative:
            beam = beam / _take(-sol.scale_tau / mu0, l)
        up = up + _take(sol.fb_up, l) * beam
        dn = dn + _take(sol.fb_dn, l) * beam
    up = 2.0 * math.pi * up
    diffuse = 2.0 * math.pi * dn
    direct = torch.zeros_like(tau)
    if cfg.has_beam:
        I0 = sol.I0[:, None]
        if antiderivative:
            direct = I0 * mu0 * torch.exp(-tau / mu0) * -mu0
            direct_scaled = I0 * mu0 * torch.exp(-st / mu0) / _take(-sol.scale_tau / mu0, l)
        else:
            direct = I0 * mu0 * torch.exp(-tau / mu0)
            direct_scaled = I0 * mu0 * torch.exp(-st / mu0)
        diffuse = diffuse + direct_scaled - direct
    r = sol.rescale_factor[:, None]
    return r * up, r * diffuse, r * direct
