"""Single-column discrete-ordinates solve: problem -> spectral solution.

Counterpart of ``pythonic_disort_tpu/models/disort/solve.py``.  One
atmosphere, every feature: beam, isotropic internal source, BDRF surface,
delta-M scaling, any number of Fourier modes and layers.  The Fourier
modes and layers are leading batch axes of tensor code: one eigen stage
for all (mode, layer) pairs (`ops.eig.disort_eigh`: CUDA kernel 1, or
kernel 5 at odd N and N > 32) and one block-tridiagonal solve for all
modes (`ops.blocktri.solve_block_tridiag`: the generic block-Thomas CUDA
kernel 3, or kernel 6 for NQuad > 64).  The tensors
of the problem carry no batch axis here; `batch_solve.solve_batched` is
the batched path.

Tables that depend on the configuration alone are cached per
(configuration, dtype, device), so a solve copies nothing from the host
beyond the problem itself.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...ops.blocktri import solve_block_tridiag
from ...ops.eig import disort_eigh
from ...ops.legendre import normalized_assoc_legendre, normalized_assoc_legendre_host
from ...ops.quadrature import double_gauss
from .types import DisortProblem, DisortSolution


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k) -> (..., n)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


class _Tables(NamedTuple):
    mu: torch.Tensor             # (N,) quadrature nodes
    w: torch.Tensor              # (N,) weights
    leg_weights: torch.Tensor    # (NLeg_all,) 2l + 1
    lam_mu: torch.Tensor         # (NF, NLeg, N) Legendre basis at the nodes
    mode_mask: torch.Tensor      # (NF, NLeg) l >= m
    parity: torch.Tensor         # (NF, NLeg) (-1)^(l - m) where l >= m
    bdrf_delta: torch.Tensor     # (NF,) 2 for m = 0, else 1


@functools.lru_cache(maxsize=None)
def _tables(nquad, nleg, nleg_all, nfourier, dtype, device) -> _Tables:
    """Tables that depend on the configuration alone, built on the host once
    per (configuration, dtype, device) and kept there: a copy from pageable
    host memory synchronizes the stream, so a solve makes none."""
    const = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    mu, w = double_gauss(nquad)
    ms = np.arange(nfourier)[:, None]
    lseq = np.arange(nleg)[None, :]
    return _Tables(
        mu=const(mu),
        w=const(w),
        leg_weights=const(2 * np.arange(nleg_all) + 1),
        lam_mu=const(normalized_assoc_legendre_host(nfourier, nleg, mu)),
        mode_mask=const((lseq >= ms).astype(np.float64)),
        parity=const(np.where(lseq >= ms, (-1.0) ** (lseq - ms), 0.0)),
        bdrf_delta=const(np.where(np.arange(nfourier) == 0, 2.0, 1.0)),
    )


class _PolyTables(NamedTuple):
    binom: torch.Tensor       # (nc, nc) upper Pascal matrix C(j, i)
    shift_pow: torch.Tensor   # (nc, nc) long, max(j - i, 0)
    powers: torch.Tensor      # (nc,) 0 .. nc-1
    fact_rev: torch.Tensor    # (nc,) (nc-1)!, ..., 1!, 0!
    take_idx: torch.Tensor    # (nc * nc,) long, max(i - p, 0) flattened
    tri_mask: torch.Tensor    # (nc, nc) i >= p
    anti_pow: torch.Tensor    # (nc,) nc, nc-1, ..., 1


@functools.lru_cache(maxsize=None)
def _poly_tables(nc: int, dtype, device) -> _PolyTables:
    """Integer tables of the source-polynomial algebra for ``nc`` coefficients."""
    const = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    index = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    ii, jj = np.meshgrid(np.arange(nc), np.arange(nc), indexing="ij")
    binom = np.where(jj >= ii, [[math.comb(j, i) for j in range(nc)] for i in range(nc)], 0.0)
    fact = np.array([math.factorial(k) for k in range(nc)], np.float64)
    return _PolyTables(
        binom=const(binom),
        shift_pow=index(np.where(jj >= ii, jj - ii, 0)),
        powers=const(np.arange(nc)),
        fact_rev=const(fact[::-1].copy()),
        take_idx=index(np.where(ii - jj >= 0, ii - jj, 0).reshape(-1)),
        tri_mask=const(ii - jj >= 0),
        anti_pow=const(np.arange(nc, 0, -1)),
    )


def _power_ladder(x: torch.Tensor, count: int) -> torch.Tensor:
    """``x^0 .. x^(count-1)`` on a new last axis, by repeated products.

    Not ``pow``: it is exp(p log x) on some back ends, NaN for negative
    bases and for 0^0, and both occur (negative delta-M shifts; tau = 0).
    Not ``cumprod`` either: on the card its scan over a short last axis
    took 14 of a longwave chunk's 21 ms (H100, ``chip_smoke.py`` phase 8).
    """
    powers = [torch.ones_like(x)]
    for _ in range(count - 1):
        powers.append(powers[-1] * x)
    return torch.stack(powers, dim=-1)


def affine_transform_poly_coeffs(poly_coeffs, a_arr, b_arr):
    """Coefficients of ``p((y-b)/a)`` given those of ``p(x)``, batched.

    ``poly_coeffs`` is (..., L, Nc), ascending order; returns the same
    shape such that ``sum_i D_i y^i = sum_i C_i x^i`` under
    ``y = a x + b`` (``a_arr``/``b_arr``: (..., L), ``a > 0``).
    """
    nc = poly_coeffs.shape[-1]
    tab = _poly_tables(nc, poly_coeffs.dtype, poly_coeffs.device)
    inv_a = (1.0 / a_arr)[..., None, None] ** tab.powers
    # the shifts b are negative whenever scale_tau varies between layers
    ladder = _power_ladder(-b_arr, nc)                          # (..., L, nc)
    shifts = ladder[..., tab.shift_pow]                         # (..., L, nc, nc)
    T = tab.binom * inv_a * shifts
    return torch.einsum("...lij,...lj->...li", T, poly_coeffs)


def iso_particular_tensor(G0, K0, G_inv_mu_inv, s_poly_desc):
    """The isotropic-source particular-solution tensor ``mathscr_b``.

    The particular solution for a per-layer polynomial source is itself
    polynomial in tau: ``v_l(tau)[q] = sum_i b[l, q, i] tau^(n-i)``
    (descending powers).  Returns ``b`` (L, 2N, Ns); the boundary-value
    right-hand side and the evaluation functions both use it.

    ``G0``, ``K0``: (L, 2N, 2N), (L, 2N) mode-0 eigendata;
    ``G_inv_mu_inv``: (L, 2N) ``G^-1 @ [1/mu, -1/mu]``; ``s_poly_desc``:
    (L, Ns) source polynomial, descending order.
    """
    ns = s_poly_desc.shape[-1]
    tab = _poly_tables(ns, s_poly_desc.dtype, s_poly_desc.device)
    # K_invP[l, k, p] = K_inv^(p+1)
    K_invP = _power_ladder(1.0 / K0, ns + 1)[..., 1:]
    # weighted_a[l, i] = s_desc[l, i] * (n - i)!
    weighted_a = s_poly_desc * tab.fact_rev[None, :]
    lower_tri = weighted_a[:, tab.take_idx].reshape(-1, ns, ns) * tab.tri_mask[None]   # (L, i, p)
    ub = torch.einsum("lkp,lip->lki", K_invP, lower_tri)        # (L, 2N, i)
    b_right = ub / tab.fact_rev[None, None, :] * G_inv_mu_inv[:, :, None]
    return torch.einsum("lqk,lki->lqi", G0, b_right)            # (L, 2N, Ns)


def iso_poly_eval(b_rows, tau, scale_tau_l=None, antiderivative=False):
    """Evaluate ``v(tau)[..., q] = sum_i b[..., q, i] tau^(n-i)``.

    ``b_rows``: (..., R, Ns) rows of ``mathscr_b`` already gathered per
    tau point; ``tau``: (...,).  With ``antiderivative``, evaluates the
    tau-antiderivative ``sum_i b_i tau^(n-i+1) / ((n-i+1) scale_tau)``.
    """
    ns = b_rows.shape[-1]
    tau_poly = _power_ladder(tau, ns).flip(-1)                  # tau^n .. tau, 1
    if antiderivative:
        p = _poly_tables(ns, b_rows.dtype, b_rows.device).anti_pow
        tau_poly = tau_poly * tau[..., None] / (p * scale_tau_l[..., None])
    return torch.einsum("...qi,...i->...q", b_rows, tau_poly)


class _SolveTables(NamedTuple):
    lamlam: torch.Tensor       # (NF, NLeg, N*N) lam(mu_i) lam(mu_j)
    lamlam_par: torch.Tensor   # the same times (-1)^(l - m)
    beam_delta: torch.Tensor   # (NF, 1, 1): 1 for m = 0, else 2


@functools.lru_cache(maxsize=None)
def _solve_tables(nquad, nleg, nleg_all, nfourier, dtype, device) -> _SolveTables:
    tab = _tables(nquad, nleg, nleg_all, nfourier, dtype, device)
    N = nquad // 2
    lamlam = (tab.lam_mu[:, :, :, None] * tab.lam_mu[:, :, None, :]).reshape(nfourier, nleg, N * N)
    return _SolveTables(
        lamlam=lamlam,
        lamlam_par=lamlam * tab.parity[:, :, None],
        beam_delta=(3.0 - tab.bdrf_delta)[:, None, None],
    )


def solve(problem: DisortProblem) -> DisortSolution:
    """Solve the 1D RTE for one atmosphere; returns the spectral solution.

    The problem's tensors carry no batch axis (``tau_arr`` is (L,),
    ``mu0`` a scalar tensor).  Input validation lives in `api.build_problem`.
    """
    cfg = problem.config
    N, NF, L = cfg.n, cfg.nfourier, cfg.nlayers
    NLeg, NB, Ns = cfg.nleg, cfg.nbdrf, cfg.nscoeffs

    tau_arr = problem.tau_arr
    dtype, device = tau_arr.dtype, tau_arr.device
    omega_arr, f_arr = problem.omega_arr, problem.f_arr
    mu0, I0, phi0 = problem.mu0, problem.I0, problem.phi0
    tab = _tables(cfg.nquad, NLeg, cfg.nleg_all, NF, dtype, device)
    stab = _solve_tables(cfg.nquad, NLeg, cfg.nleg_all, NF, dtype, device)
    mu, w = tab.mu, tab.w
    M_inv = 1.0 / mu

    zero1 = torch.zeros((1,), dtype=dtype, device=device)
    thickness = torch.diff(tau_arr, prepend=zero1)
    weighted_leg_all = tab.leg_weights[None, :] * problem.leg_coeffs_all
    leg = problem.leg_coeffs_all[:, :NLeg]

    # ---- delta-M scaling (reference pydisort.py:313-344) ----
    if cfg.has_deltam:
        scale_tau = 1.0 - omega_arr * f_arr
        scaled_tau_with_0 = torch.cat([zero1, torch.cumsum(scale_tau * thickness, dim=0)])
        scaled_leg = (leg - f_arr[:, None]) / (1.0 - f_arr)[:, None]
        scaled_omega = (1.0 - f_arr) / scale_tau * omega_arr
    else:
        scale_tau = torch.ones((L,), dtype=dtype, device=device)
        scaled_tau_with_0 = torch.cat([zero1, tau_arr])
        scaled_leg = leg
        scaled_omega = omega_arr
    weighted_scaled_leg = scaled_leg * tab.leg_weights[None, :NLeg]

    if cfg.has_iso:
        if cfg.has_deltam:
            tau_tops = torch.cat([zero1, tau_arr[:-1]])
            translations = scaled_tau_with_0[:-1] - scale_tau * tau_tops
            scaled_s_poly = (
                affine_transform_poly_coeffs(problem.s_poly_coeffs, scale_tau, translations)
                / scale_tau[:, None]
            ) * (1.0 - omega_arr)[:, None]
        else:
            scaled_s_poly = problem.s_poly_coeffs * (1.0 - omega_arr)[:, None]
    else:
        scaled_s_poly = torch.zeros((L, 1), dtype=dtype, device=device)

    # ---- source rescaling for conditioning (reference pydisort.py:348-373) ----
    b_pos, b_neg = problem.b_pos, problem.b_neg
    candidates = [I0, b_pos.max(), b_neg.max()]
    if cfg.has_iso:
        taup = _power_ladder(scaled_tau_with_0[-1], Ns)
        candidates += [scaled_s_poly[0, 0], scaled_s_poly[-1, :] @ taup]
    rescale = torch.stack(candidates).max()
    rescale = torch.where(rescale > 0, rescale, torch.ones_like(rescale))
    I0 = I0 / rescale
    b_pos = b_pos / rescale
    b_neg = b_neg / rescale
    scaled_s_poly = scaled_s_poly / rescale
    I0_div_4pi = I0 / (4.0 * math.pi)

    # ---- phase-function kernels for all modes at once ----
    lam_mu, mode_mask, parity = tab.lam_mu, tab.mode_mask, tab.parity
    # coeff[m, l, c] = (omega_l/2)(2c+1) g_{l,c}, zero for c < m
    coeff = ((scaled_omega[:, None] / 2.0) * weighted_scaled_leg)[None] * mode_mask[:, None, :]
    Dp = torch.bmm(coeff, stab.lamlam).reshape(NF, L, N, N)
    Dm = torch.bmm(coeff, stab.lamlam_par).reshape(NF, L, N, N)

    # ---- eigen stage for all (mode, layer) pairs ----
    K_pos, X, Y, P, Q = disort_eigh(Dp, Dm, mu, w)              # (NF, L, ...)
    a_blk = 0.5 * (X + Y)
    b_blk = 0.5 * (X - Y)
    G = torch.cat(
        [torch.cat([a_blk, b_blk], dim=-1), torch.cat([b_blk, a_blk], dim=-1)], dim=-2)
    K_full = torch.cat([-K_pos, K_pos], dim=-1)                 # (NF, L, 2N)

    # ---- beam particular solution (reference _solve...py:209-231) ----
    if cfg.has_beam:
        lam_m0 = normalized_assoc_legendre(NF, NLeg, -mu0.reshape(1))[:, :, 0]   # (NF, NLeg) at -mu0
        xfac = 2.0 * coeff * (stab.beam_delta * I0_div_4pi) * lam_m0[:, None, :]
        Xp = torch.bmm(xfac, lam_mu)                            # (NF, L, N)
        Xn = torch.bmm(xfac * parity[:, None, :], lam_mu)
        # G^-1 X via the P/Q blocks, then scale by 1/(1/mu0 + K), then G @
        xp, xn = M_inv * Xp, -M_inv * Xn
        Pp, Pn, Qp, Qn = _mv(P, xp), _mv(P, xn), _mv(Q, xp), _mv(Q, xn)
        y_top = 0.5 * (Pp + Qp + Pn - Qn)
        y_bot = 0.5 * (Pp - Qp + Pn + Qn)
        ycat = torch.cat([y_top, y_bot], dim=-1) / (1.0 / mu0 + K_full)
        zt, zb = ycat[..., :N], ycat[..., N:]
        B = torch.cat([_mv(a_blk, zt) + _mv(b_blk, zb), _mv(b_blk, zt) + _mv(a_blk, zb)], dim=-1)
    else:
        B = torch.zeros((NF, L, 2 * N), dtype=dtype, device=device)

    # ---- isotropic-source particular tensor (mode 0) ----
    if cfg.has_iso:
        QM = torch.matmul(Q[0], M_inv)                          # (L, N)
        G_inv_mu_inv = torch.cat([QM, -QM], dim=-1)
        mathscr_b = iso_particular_tensor(G[0], K_full[0], G_inv_mu_inv, scaled_s_poly.flip(-1))
    else:
        mathscr_b = torch.zeros((L, 2 * N, 1), dtype=dtype, device=device)

    # ---- BDRF operators, padded over modes (reference _solve_for_coeffs.py:118-135) ----
    mu_w = mu * w
    R = torch.zeros((NF, N, N), dtype=dtype, device=device)
    X_bdrf = torch.zeros((NF, N), dtype=dtype, device=device)
    if NB > 0:
        nb = min(NB, NF)
        R[:nb] = tab.bdrf_delta[:nb, None, None] * problem.bdrf_modes[:nb] * mu_w[None, None, :]
        if cfg.has_beam:
            X_bdrf[:nb] = (4.0 * mu0 * I0_div_4pi) * problem.bdrf_modes_mu0[:nb]

    # ---- boundary-value problem: block-tridiagonal assembly & solve ----
    decay = torch.exp(-K_pos * (scaled_tau_with_0[1:] - scaled_tau_with_0[:-1])[None, :, None])
    # layer basis evaluated at its bottom (Mtop) and top (Mbot) interfaces
    Mtop = torch.cat([G[..., :N] * decay[..., None, :], G[..., N:]], dim=-1)
    Mbot = torch.cat([G[..., :N], G[..., N:] * decay[..., None, :]], dim=-1)

    # Bottom BC rows: (G_pn - R G_nn) decay | (G_pp - R G_np)
    GL = G[:, -1]
    bot_left = (GL[:, :N, :N] - torch.bmm(R, GL[:, N:, :N])) * decay[:, -1, None, :]
    bot_right = GL[:, :N, N:] - torch.bmm(R, GL[:, N:, N:])
    Bt = torch.cat([bot_left, bot_right], dim=-1)               # (NF, N, 2N)

    if L == 1:
        Dg = torch.cat([Mbot[:, 0, N:, :], Bt], dim=1)[:, None]
        lower = torch.zeros_like(Dg)
        upper = torch.zeros_like(Dg)
    else:
        d_top = torch.cat([Mbot[:, 0:1, N:, :], -Mbot[:, 1:, N:, :]], dim=1)
        d_bot = torch.cat([Mtop[:, : L - 1, :N, :], Bt[:, None]], dim=1)
        Dg = torch.cat([d_top, d_bot], dim=2)                   # (NF, L, 2N, 2N)
        zN = torch.zeros((NF, 1, N, 2 * N), dtype=dtype, device=device)
        zL = torch.zeros((NF, L, N, 2 * N), dtype=dtype, device=device)
        lower = torch.cat([torch.cat([zN, Mtop[:, : L - 1, N:, :]], dim=1), zL], dim=2)
        upper = torch.cat([zL, torch.cat([-Mbot[:, 1:, :N, :], zN], dim=1)], dim=2)

    # RHS (reference _solve_for_coeffs.py:139-256)
    rhs_top = b_neg.T.expand(NF, N)
    rhs_bot = b_pos.T.expand(NF, N)
    if cfg.has_beam:
        beam_decay_bot = torch.exp(-scaled_tau_with_0[-1] / mu0)
        rhs_top = rhs_top - B[:, 0, N:]
        rhs_bot = rhs_bot + (X_bdrf + _mv(R, B[:, -1, N:]) - B[:, -1, :N]) * beam_decay_bot

    if cfg.has_iso:
        v_top = iso_poly_eval(mathscr_b[0], torch.zeros((), dtype=dtype, device=device))   # (2N,)
        v_bot = iso_poly_eval(mathscr_b[-1], scaled_tau_with_0[-1])
        rhs_top, rhs_bot = rhs_top.clone(), rhs_bot.clone()
        rhs_top[0] -= v_top[N:]
        rhs_bot[0] += -v_bot[:N] + R[0] @ v_bot[N:]

    if L > 1:
        cont_rhs = torch.zeros((NF, L - 1, 2 * N), dtype=dtype, device=device)
        if cfg.has_beam:
            bdecay = torch.exp(-scaled_tau_with_0[1:-1] / mu0)
            cont_rhs = cont_rhs + (B[:, 1:, :] - B[:, :-1, :]) * bdecay[None, :, None]
        if cfg.has_iso:
            tb = scaled_tau_with_0[1:-1]                        # (L-1,)
            cont_rhs[0] += iso_poly_eval(mathscr_b[1:], tb) - iso_poly_eval(mathscr_b[:-1], tb)
        rhs = torch.cat(
            [torch.cat([rhs_top[:, None, :], cont_rhs[:, :, N:]], dim=1),
             torch.cat([cont_rhs[:, :, :N], rhs_bot[:, None, :]], dim=1)], dim=2)   # (NF, L, 2N)
    else:
        rhs = torch.cat([rhs_top, rhs_bot], dim=1)[:, None]

    # recursion over the layers, batch over the modes
    C = solve_block_tridiag(
        lower.movedim(1, 0), Dg.movedim(1, 0), upper.movedim(1, 0), rhs.movedim(1, 0))
    C = C.movedim(0, 1)                                         # (NF, L, 2N)
    GC = G * C[:, :, None, :]

    # flux tables: (mu W)-contracted mode-0 data, so the flux evaluators
    # gather per-layer vectors instead of (2N, 2N) blocks (see eval.py)
    fvec_up = torch.einsum("i,lij->lj", mu_w, GC[0][:, :N, :])
    fvec_dn = torch.einsum("i,lij->lj", mu_w, GC[0][:, N:, :])

    return DisortSolution(
        config=cfg,
        G=G,
        K=K_full,
        GC=GC.reshape(NF, L, -1),
        B=B,
        mathscr_b=mathscr_b,
        tau_arr=tau_arr,
        scaled_tau_with_0=scaled_tau_with_0,
        scale_tau=scale_tau,
        mu_arr_pos=mu,
        W=w,
        mu0=mu0,
        I0=I0,
        phi0=phi0,
        rescale_factor=rescale,
        omega_arr=omega_arr,
        f_arr=f_arr,
        scaled_omega_arr=scaled_omega,
        weighted_leg_all=weighted_leg_all,
        weighted_scaled_leg=weighted_scaled_leg,
        fvec_up=fvec_up,
        fvec_dn=fvec_dn,
        fb_up=B[0][:, :N] @ mu_w,
        fb_dn=B[0][:, N:] @ mu_w,
        fi_up=torch.einsum("i,lik->lk", mu_w, mathscr_b[:, :N, :]),
        fi_dn=torch.einsum("i,lik->lk", mu_w, mathscr_b[:, N:, :]),
    )
