"""Evaluation functions over a `DisortSolution`.

Counterpart of ``pythonic_disort_tpu/models/disort/eval.py``.  Each
function takes a batched solution (every tensor with a leading S, probe
depths (S, Ntau), azimuths (S, Nphi)) or a single-column one (no S axis,
probes (Ntau,), (Nphi,)); a single column is evaluated as a batch of one
and the S axis is dropped from the result.

Conventions (matching the reference):
- the first ``N`` rows of intensity outputs are upward (positive mu,
  ascending), the last ``N`` downward;
- ``antiderivative=True`` evaluates the exact tau-antiderivative of the
  output (the reference's ``is_antiderivative_wrt_tau``);
- outputs are in physical units (multiplied by the solve's internal
  rescale factor).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .solve import iso_poly_eval
from .types import DisortSolution


def _lift(sol: DisortSolution) -> DisortSolution:
    """A single-column solution as a batch of one (views, no copies)."""
    fields = {f.name: getattr(sol, f.name) for f in dataclasses.fields(sol) if f.name != "config"}
    return dataclasses.replace(
        sol, **{k: v[None] for k, v in fields.items() if isinstance(v, torch.Tensor)})


def _either(fn):
    """Let a batched evaluator take a single-column solution as well."""

    @functools.wraps(fn)
    def evaluate(sol, *args, **kwargs):
        if sol.tau_arr.dim() == 2:
            return fn(sol, *args, **kwargs)
        args = [torch.atleast_1d(a)[None] if isinstance(a, torch.Tensor) else a for a in args]
        out = fn(_lift(sol), *args, **kwargs)
        return tuple(x[0] for x in out) if isinstance(out, tuple) else out[0]

    return evaluate


def _take(x: torch.Tensor, l: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gather the layer axis ``dim`` of ``x`` (S, ..., L, ...) at the
    (S, Ntau) layer indices ``l``; the result has Ntau in place of L."""
    view = [1] * x.dim()
    view[0], view[dim] = l.shape
    shape = list(x.shape)
    shape[dim] = l.shape[1]
    return torch.gather(x, dim, l.reshape(view).expand(shape))


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
    """Overflow-free homogeneous exponents, all <= 0.

    Negative-K columns anchor at the layer top, positive-K at the layer
    bottom (reference _assemble...py:197-203).  ``K``: (S, L, 2N) gives
    (S, Ntau, 2N); ``K``: (S, NF, L, 2N) gives (S, NF, Ntau, 2N).
    """
    N = sol.config.n
    d_top = (scaled_tau - _take(sol.scaled_tau_with_0[:, :-1], l))[..., None]
    d_bot = (scaled_tau - _take(sol.scaled_tau_with_0[:, 1:], l))[..., None]
    if K.dim() == 4:
        d_top, d_bot = d_top[:, None], d_bot[:, None]
    Kl = _take(K, l, dim=K.dim() - 2)
    return torch.cat([Kl[..., :N] * d_top, Kl[..., N:] * d_bot], dim=-1)


def _beam_factor(sol: DisortSolution, l, scaled_tau, antiderivative):
    """``exp(-tau / mu0)`` of the scaled tau, or its antiderivative; (S, Ntau)."""
    mu0 = sol.mu0[:, None]
    beam = torch.exp(-scaled_tau / mu0)
    if antiderivative:
        beam = beam / _take(-sol.scale_tau / mu0, l)
    return beam


def _iso_contribution(sol: DisortSolution, l, scaled_tau, antiderivative):
    """Iso-source particular solution at probe points; (S, Ntau, 2N)."""
    return iso_poly_eval(_take(sol.mathscr_b, l), scaled_tau, _take(sol.scale_tau, l), antiderivative)


@_either
def u0(sol: DisortSolution, tau, antiderivative: bool = False):
    """Zeroth Fourier intensity mode; (S, 2N, Ntau).

    Capability parity: reference ``_assemble...py:334-433``.
    """
    cfg = sol.config
    n2 = 2 * cfg.n
    l = _layer_index(sol, tau)
    st = _scaled_tau(sol, tau, l)
    K0 = sol.K[:, 0]
    expo = torch.exp(_exponent(sol, l, st, K0))
    if antiderivative:
        expo = expo / (_take(sol.scale_tau, l)[..., None] * _take(K0, l))
    # GC is stored layer-flattened; gather rows per tau, then unflatten
    gc0 = _take(sol.GC[:, 0], l).reshape(l.shape + (n2, n2))
    out = torch.einsum("stij,stj->sti", gc0, expo)
    if cfg.has_beam:
        out = out + _take(sol.B[:, 0], l) * _beam_factor(sol, l, st, antiderivative)[..., None]
    if cfg.has_iso:
        out = out + _iso_contribution(sol, l, st, antiderivative)
    return sol.rescale_factor[:, None, None] * out.permute(0, 2, 1)


@_either
def act_dscale_reclassification(sol: DisortSolution, tau, antiderivative: bool = False):
    """Delta-scaling reclassification term for downward actinic flux; (S, Ntau).

    Reference ``_assemble...py:358-371``.  To match the reference this term
    uses the internally rescaled beam intensity and is not multiplied by
    the rescale factor (reference ``subroutines.py:301-316`` adds it to
    already-rescaled output).
    """
    if not sol.config.has_deltam or not sol.config.has_beam:
        return torch.zeros_like(tau)
    l = _layer_index(sol, tau)
    st = _scaled_tau(sol, tau, l)
    I0, mu0 = sol.I0[:, None], sol.mu0[:, None]
    if antiderivative:
        return I0 * _beam_factor(sol, l, st, True) - I0 * torch.exp(-tau / mu0) * -mu0
    return I0 * torch.exp(-st / mu0) - I0 * torch.exp(-tau / mu0)


@_either
def fluxes_all(sol: DisortSolution, tau: torch.Tensor, antiderivative: bool = False):
    """``(flux_up, flux_down_diffuse, flux_down_direct)``, each (S, Ntau).

    Reads the per-layer flux tables (``fvec_*``, ``fb_*``, ``fi_*``) at
    each probe's layer.  Reference ``_assemble...py:446-613``, including
    the delta-M reclassification of the direct beam into the diffuse flux.
    """
    cfg = sol.config
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
        beam = _beam_factor(sol, l, st, antiderivative)
        up = up + _take(sol.fb_up, l) * beam
        dn = dn + _take(sol.fb_dn, l) * beam
    if cfg.has_iso:
        scale_l = _take(sol.scale_tau, l)
        up = up + iso_poly_eval(_take(sol.fi_up, l)[:, :, None, :], st, scale_l, antiderivative)[..., 0]
        dn = dn + iso_poly_eval(_take(sol.fi_dn, l)[:, :, None, :], st, scale_l, antiderivative)[..., 0]
    up = 2.0 * math.pi * up
    diffuse = 2.0 * math.pi * dn
    direct = torch.zeros_like(tau)
    if cfg.has_beam:
        I0 = sol.I0[:, None]
        if antiderivative:
            direct = I0 * mu0 * torch.exp(-tau / mu0) * -mu0
        else:
            direct = I0 * mu0 * torch.exp(-tau / mu0)
        diffuse = diffuse + I0 * mu0 * beam - direct
    r = sol.rescale_factor[:, None]
    return r * up, r * diffuse, r * direct


def flux_up(sol: DisortSolution, tau, antiderivative: bool = False):
    """Upward diffuse flux; (S, Ntau).  Reference ``_assemble...py:446-524``."""
    return fluxes_all(sol, tau, antiderivative)[0]


def flux_down(sol: DisortSolution, tau, antiderivative: bool = False):
    """Downward (diffuse, direct) fluxes; each (S, Ntau).

    Reference ``_assemble...py:527-613``.
    """
    return fluxes_all(sol, tau, antiderivative)[1:]


@_either
def u(sol: DisortSolution, tau, phi, antiderivative: bool = False,
      return_fourier_error: bool = False):
    """Full intensity; (S, 2N, Ntau, Nphi).

    Fourier cosine synthesis over all modes (reference
    ``_assemble...py:170-330``).  With ``return_fourier_error`` also
    returns the last-mode Cauchy convergence estimate, (S,).
    """
    cfg = sol.config
    NF, n2 = cfg.nfourier, 2 * cfg.n
    S, T = tau.shape
    l = _layer_index(sol, tau)
    st = _scaled_tau(sol, tau, l)
    expo = torch.exp(_exponent(sol, l, st, sol.K))             # (S, NF, Ntau, 2N)
    if antiderivative:
        expo = expo / (_take(sol.scale_tau, l)[:, None, :, None] * _take(sol.K, l, dim=2))
    gc = _take(sol.GC, l, dim=2).reshape(S, NF, T, n2, n2)
    um = torch.einsum("smtij,smtj->smti", gc, expo)
    if cfg.has_beam:
        um = um + _take(sol.B, l, dim=2) * _beam_factor(sol, l, st, antiderivative)[:, None, :, None]
    if cfg.has_iso:
        um[:, 0] += _iso_contribution(sol, l, st, antiderivative)
    um = um.permute(0, 1, 3, 2)                                # (S, NF, 2N, Ntau)

    dphi = sol.phi0[:, None] - phi                             # (S, Nphi)
    modes = torch.arange(NF, dtype=tau.dtype, device=tau.device)
    out = torch.einsum("smit,smp->sitp", um, torch.cos(modes[None, :, None] * dphi[:, None, :]))
    result = sol.rescale_factor[:, None, None, None] * out
    if not return_fourier_error:
        return result
    last_term = (um[:, -1, :, :, None] * torch.cos((NF - 1) * dphi)[:, None, None, :]).abs()
    u_abs = out.abs()
    big = u_abs > 1e-8
    ratio = torch.where(big, last_term / torch.where(big, u_abs, torch.ones_like(u_abs)),
                        torch.zeros_like(u_abs))
    return result, ratio.amax(dim=(1, 2, 3))
