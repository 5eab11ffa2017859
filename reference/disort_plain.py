"""Plain PyTorch discrete-ordinates solver with autograd: the reference
for the port's reverse mode.

A line-for-line translation of the benchmark's NumPy reference
(``benchmark/yardstick/reference.py``) into PyTorch, for the problem that
the gradient cells solve: a plane-parallel column of layers with delta-M
scaling, a collimated beam, Dirichlet boundaries (no diffuse incidence,
no surface reflection), solved mode by mode in azimuth, and the
intensity with the Nakajima-Tanaka TMS and IMS corrections.  It imports
neither JAX nor anything of the port; its derivatives come from
``torch.autograd`` alone, through every operation below.

Per (row, mode, layer) the homogeneous system is reduced to the N x N
eigenproblem (alpha - beta)(alpha + beta) (``torch.linalg.eig``, on the
host); the beam's particular solution is a direct solve; the
boundary-value problem of every (row, mode), banded with 2N x 2N blocks,
is solved by block elimination, each pivot block by an LU solve with
partial pivoting (``torch.linalg.solve``), with no dense (L 2N)^2 solve.

Everything runs in the dtype of the inputs given (``dtype``): float64
for the reference, float32 for the control of a comparison, which is
then this same algorithm in that precision.  TF32 is switched off.

    sol = solve(tau, omega, leg, f, mu0, I0, phi0, nquad, nleg, nfourier)
    u = intensity(sol, tau_eval, phi, nt_correct=True)     # (R, 2N, Q, P)
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FOUR_PI = 4.0 * math.pi


def double_gauss(nquad, like):
    """``nquad // 2`` Gauss-Legendre nodes on (0, 1), ascending, and
    weights, as tensors of ``like``'s dtype and device."""
    x, w = np.polynomial.legendre.leggauss(nquad // 2)
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return as_t(0.5 * (x + 1.0)), as_t(0.5 * w)


def assoc_legendre(nf, nleg, x):
    """Normalized associated Legendre functions
    sqrt((l-m)!/(l+m)!) P_l^m(x), for m < nf, l < nleg; (nf, nleg, *x.shape),
    zero where l < m."""
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    zero = torch.zeros_like(x)
    rows = []
    for m in range(nf):
        col = [zero] * nleg
        if m < nleg:
            c = 1.0
            for k in range(1, m + 1):
                c *= -math.sqrt((2 * k - 1) / (2 * k))
            col[m] = c * s**m
            if m + 1 < nleg:
                col[m + 1] = math.sqrt(2 * m + 1) * x * col[m]
            for l in range(m + 2, nleg):
                col[l] = ((2 * l - 1) * x * col[l - 1]
                          - math.sqrt((l - 1) ** 2 - m * m) * col[l - 2]) / math.sqrt(l * l - m * m)
        rows.append(torch.stack(col))
    return torch.stack(rows)


def legendre_series(coeffs, x):
    """sum_k coeffs[..., k] P_k(x) by the three-term recurrence; ``coeffs``
    (..., K) broadcasts against ``x``."""
    p0, p1 = torch.ones_like(x), x
    total = coeffs[..., 0] * p0
    if coeffs.shape[-1] > 1:
        total = total + coeffs[..., 1] * p1
    for k in range(2, coeffs.shape[-1]):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        total = total + coeffs[..., k] * p1
    return total


class Solution:
    """Per (row, mode, layer) eigen data, particular solutions and BVP
    coefficients of a batch of rows; evaluated by `intensity`."""


def solve(tau, omega, leg, f, mu0, I0, phi0, nquad, nleg, nfourier):
    """Solve R rows.  ``tau`` (R, L) cumulative layer bottoms, ``omega``,
    ``f`` (R, L), ``leg`` (R, L, K) Legendre coefficients of the phase
    function (``leg[..., 0] = 1``), ``mu0``, ``I0``, ``phi0`` (R,); all
    tensors of one dtype and device.  Returns a `Solution`."""
    R, L = tau.shape
    N, NF = nquad // 2, nfourier
    dtype, device = tau.dtype, tau.device
    thick = torch.diff(tau, dim=1, prepend=torch.zeros_like(tau[:, :1]))
    scale = 1.0 - omega * f
    t_bot = torch.cumsum(scale * thick, dim=1)
    t_w0 = torch.cat([torch.zeros_like(tau[:, :1]), t_bot], dim=1)
    leg_s = (leg[:, :, :nleg] - f[..., None]) / (1.0 - f[..., None])
    omega_s = (1.0 - f) * omega / scale

    mu, w = double_gauss(nquad, tau)
    lam = assoc_legendre(NF, nleg, mu)                              # (M, K, N)
    ks = torch.arange(nleg, device=device)
    ms = torch.arange(NF, device=device)
    mask = (ks[None, :] >= ms[:, None]).to(dtype)                   # (M, K)
    parity = torch.where(mask > 0, (-1.0) ** (ks[None, :] - ms[:, None]).to(dtype), torch.zeros_like(mask))
    c = 0.5 * omega_s[..., None] * (2 * ks + 1).to(dtype) * leg_s   # (R, L, K)
    cm = c[:, None] * mask[None, :, None, :]                        # (R, M, L, K)
    Dp = torch.einsum("rmlk,mki,mkj->rmlij", cm, lam, lam)
    Dm = torch.einsum("rmlk,mki,mkj->rmlij", cm * parity[None, :, None, :], lam, lam)
    Minv = 1.0 / mu
    eye = torch.eye(N, dtype=dtype, device=device)
    alpha = Minv[:, None] * (eye - Dp * w)                          # M^-1 (I - D+ W)
    beta = -Minv[:, None] * (Dm * w)                                # -M^-1 D- W

    # homogeneous: lambda^2 u = (alpha - beta)(alpha + beta) u, v = (alpha + beta) u / lambda
    apb = alpha + beta
    # LAPACK's geev on the host, on any device: no batched GPU geev exists
    k2, U = torch.linalg.eig(((alpha - beta) @ apb).cpu())
    k = torch.sqrt(torch.abs(k2.real)).to(device)
    U = U.real.to(device)
    APU = apb @ U
    v = APU / k[..., None, :]
    Vdec = torch.cat([U - v, U + v], dim=-2) * 0.5                  # eigenvalue -k (decays downward)
    Vinc = torch.cat([U + v, U - v], dim=-2) * 0.5                  # eigenvalue +k

    A = torch.cat([torch.cat([alpha, beta], -1), torch.cat([-beta, -alpha], -1)], -2)
    lam0 = assoc_legendre(NF, nleg, -mu0)                           # (M, K, R)
    delta = torch.where(ms == 0, 1.0, 2.0).to(dtype)
    src = delta[None, :, None, None] * (I0 / FOUR_PI)[:, None, None, None]
    X = 2.0 * torch.einsum("rmlk,mki,mkr->rmli", cm, lam, lam0) * src
    Xn = 2.0 * torch.einsum("rmlk,mki,mkr->rmli", cm * parity[None, :, None, :], lam, lam0) * src
    rhs = torch.cat([Minv * X, -Minv * Xn], dim=-1)
    lhs = A + torch.eye(2 * N, dtype=dtype, device=device) / mu0[:, None, None, None, None]
    beam = torch.linalg.solve(lhs, rhs[..., None])[..., 0]         # (R, M, L, 2N) times exp(-t/mu0)

    sol = Solution()
    sol.__dict__.update(R=R, L=L, N=N, NF=NF, nleg=nleg, mu=mu, w=w, tau=tau, omega=omega, leg=leg, f=f,
                        leg_s=leg_s, omega_s=omega_s, scale=scale, t_w0=t_w0, mu0=mu0, I0=I0, phi0=phi0,
                        k=k, Vdec=Vdec, Vinc=Vinc, beam=beam)
    sol.C = _bvp(sol)
    return sol


def _gather_layer(x, l):
    """``x`` (R, M, L, ...) at layers ``l`` (R, Q): (R, M, Q, ...)."""
    rr = torch.arange(x.shape[0], device=x.device)[:, None]
    return x.transpose(1, 2)[rr, l].transpose(1, 2)


def _particular(sol, l, t):
    """Particular solution of layers ``l`` (R, Q) at scaled depths ``t``
    (R, Q): (R, M, Q, 2N)."""
    return _gather_layer(sol.beam, l) * torch.exp(-t / sol.mu0[:, None])[:, None, :, None]


def _homogeneous(sol, l, t):
    """The 2N homogeneous basis solutions of layers ``l`` at scaled depths
    ``t``: (R, M, Q, 2N rows, 2N columns), columns [decaying | growing]."""
    rr = torch.arange(sol.R, device=t.device)[:, None]
    top, bot = sol.t_w0[rr, l], sol.t_w0[rr, l + 1]
    k = _gather_layer(sol.k, l)                                      # (R, M, Q, N)
    e_dec = torch.exp(-k * (t - top)[:, None, :, None])
    e_inc = torch.exp(-k * (bot - t)[:, None, :, None])
    Vd = _gather_layer(sol.Vdec, l)
    Vi = _gather_layer(sol.Vinc, l)
    return torch.cat([Vd * e_dec[..., None, :], Vi * e_inc[..., None, :]], dim=-1)


def _bvp(sol):
    """Coefficients (R, M, L, 2N) of the homogeneous solutions: continuity
    at every interface, the top's downward intensities zero, the bottom's
    upward ones zero.

    The rows of the banded system, taken 2N at a time from the top, make
    block row l: the N top rows (l = 0) or the lower N rows of interface
    l - 1, then the upper N rows of interface l or the N bottom rows
    (l = L - 1); it couples layers l - 1, l and l + 1.  Block elimination
    down the column, then back substitution."""
    R, L, N, NF = sol.R, sol.L, sol.N, sol.NF
    ones = torch.ones((R, 1), dtype=torch.long, device=sol.tau.device)
    Htop, Hbot, Ptop, Pbot = [], [], [], []                          # layer l at its top and bottom
    for l in range(L):
        for H, P, t in ((Htop, Ptop, sol.t_w0[:, l:l + 1]), (Hbot, Pbot, sol.t_w0[:, l + 1:l + 2])):
            H.append(_homogeneous(sol, l * ones, t)[:, :, 0])        # (R, M, 2N, 2N)
            P.append(_particular(sol, l * ones, t)[:, :, 0])         # (R, M, 2N)
    zero = torch.zeros_like(Htop[0][..., :N, :])
    diag, lower, upper, rhs = [], [], [], []
    for l in range(L):
        # upper N rows: the top boundary, or interface l - 1 below its first N rows
        if l == 0:
            d_up, r_up, lo = Htop[0][..., N:, :], -Ptop[0][..., N:], None
        else:
            d_up = -Htop[l][..., N:, :]
            r_up = (Ptop[l] - Pbot[l - 1])[..., N:]
            lo = torch.cat([Hbot[l - 1][..., N:, :], zero], dim=-2)
        # lower N rows: interface l's first N rows, or the bottom boundary
        if l == L - 1:
            d_dn, r_dn, up = Hbot[l][..., :N, :], -Pbot[l][..., :N], None
        else:
            d_dn = Hbot[l][..., :N, :]
            r_dn = (Ptop[l + 1] - Pbot[l])[..., :N]
            up = torch.cat([zero, -Htop[l + 1][..., :N, :]], dim=-2)
        diag.append(torch.cat([d_up, d_dn], dim=-2))
        rhs.append(torch.cat([r_up, r_dn], dim=-1))
        lower.append(lo)
        upper.append(up)
    W, g = [], []
    for l in range(L):
        D, r = diag[l], rhs[l]
        if l > 0:
            D = D - lower[l] @ W[-1]
            r = r - (lower[l] @ g[-1][..., None])[..., 0]
        if l < L - 1:
            sol_l = torch.linalg.solve(D, torch.cat([upper[l], r[..., None]], dim=-1))
            W.append(sol_l[..., :-1])
            g.append(sol_l[..., -1])
        else:
            g.append(torch.linalg.solve(D, r[..., None])[..., 0])
    xs = [g[-1]]
    for l in range(L - 2, -1, -1):
        xs.append(g[l] - (W[l] @ xs[-1][..., None])[..., 0])
    return torch.stack(xs[::-1], dim=2)                              # (R, M, L, 2N)


def _layer_of(sol, tau_eval):
    """Layer of each probe, tau in (tau_{l-1}, tau_l] (tau = 0 in layer 0),
    and its scaled depth."""
    l = torch.clamp((sol.tau[:, None, :] < tau_eval[..., None]).sum(-1), max=sol.L - 1)
    rr = torch.arange(sol.R, device=tau_eval.device)[:, None]
    t = sol.t_w0[rr, l + 1] - (sol.tau[rr, l] - tau_eval) * sol.scale[rr, l]
    return l, t


def modes_at(sol, tau_eval):
    """Intensity Fourier modes (R, M, Q, 2N) at unscaled ``tau_eval`` (R, Q)."""
    l, t = _layer_of(sol, tau_eval)
    H = _homogeneous(sol, l, t)
    C = _gather_layer(sol.C, l)                                      # (R, M, Q, 2N)
    return torch.einsum("rmqij,rmqj->rmqi", H, C) + _particular(sol, l, t)


def intensity(sol, tau_eval, phi, nt_correct=False):
    """u (R, 2N, Q, P) at ``tau_eval`` (R, Q) and azimuths ``phi`` (R, P):
    the modes' cosine series, plus the Nakajima-Tanaka TMS and IMS
    corrections with ``nt_correct``."""
    um = modes_at(sol, tau_eval)                                     # (R, M, Q, 2N)
    m = torch.arange(sol.NF, dtype=phi.dtype, device=phi.device)
    cos = torch.cos(m[None, :, None] * (sol.phi0[:, None, None] - phi[:, None, :]))
    u = torch.einsum("rmqi,rmp->riqp", um, cos)
    if nt_correct:
        u = u + _tms(sol, tau_eval, phi) + _ims(sol, tau_eval, phi)
    return u


def _scatter_cos(mu, phi, mu_in, phi_in):
    """cos of the angle between directions (mu, phi) and (mu_in, phi_in):
    (R, len(mu), P) for mu (I,), phi (R, P), mu_in and phi_in (R,)."""
    return (mu_in[:, None, None] * mu[None, :, None]
            + torch.sqrt(1 - mu_in**2)[:, None, None] * torch.sqrt(1 - mu**2)[None, :, None]
            * torch.cos(phi_in[:, None] - phi)[:, None, :])


def _tms(sol, tau_eval, phi):
    """Exact-minus-truncated single scattering of the beam (TMS), summed
    over the layers a stream crosses: (R, 2N, Q, P).  As PythonicDISORT
    does, every crossed layer's scattering is weighted by the albedo and
    phase-function difference of the probe's own layer."""
    R = sol.R
    dtype = sol.tau.dtype
    mu = torch.cat([sol.mu, -sol.mu])
    nu = _scatter_cos(mu, phi, -sol.mu0, sol.phi0)                   # (R, 2N, P)
    K = sol.leg.shape[-1]
    full = (2 * torch.arange(K, device=mu.device) + 1).to(dtype) * sol.leg       # (R, L, K)
    trunc = (2 * torch.arange(sol.nleg, device=mu.device) + 1).to(dtype) * sol.leg_s
    p_full = legendre_series(full[:, :, None, None, :], nu[:, None])  # (R, L, 2N, P)
    p_trunc = legendre_series(trunc[:, :, None, None, :], nu[:, None])
    mu0 = sol.mu0[:, None, None, None]
    Bl = ((sol.omega_s * sol.I0[:, None] / FOUR_PI)[:, :, None, None] * (mu0 / (mu0 + mu[None, None, :, None]))
          * (p_full / (1 - sol.f)[:, :, None, None] - p_trunc))       # (R, L, 2N, P)
    l, t = _layer_of(sol, tau_eval)                                  # (R, Q)
    Bq = Bl[torch.arange(R, device=mu.device)[:, None], l]           # (R, Q, 2N, P)
    top, bot = sol.t_w0[:, :-1], sol.t_w0[:, 1:]                     # (R, L)
    m0 = sol.mu0[:, None, None, None]
    mi = sol.mu[None, :, None, None]
    tq = t[:, None, :, None]                                         # (R, 1, Q, 1)
    # every exponent of a crossed layer is <= 0; the clip keeps the others finite
    ex = lambda z: torch.exp(torch.clamp(z, max=0.0))
    # upward: layers j whose part below t is crossed, a = max(t, top_j), b = bot_j
    a = torch.maximum(tq, top[:, None, None, :])
    b = bot[:, None, None, :]
    up = torch.where(b > tq, ex(-(a - tq) / mi - a / m0) - ex(-(b - tq) / mi - b / m0), 0.0)   # (R, N, Q, L)
    # downward: a = top_j, b = min(t, bot_j)
    a = top[:, None, None, :]
    b = torch.minimum(tq, bot[:, None, None, :])
    dn = torch.where(a < tq, ex(-(tq - b) / mi - b / m0) - ex(-(tq - a) / mi - a / m0), 0.0)
    fac = torch.cat([up, dn], dim=1).sum(-1)                         # (R, 2N, Q)
    return Bq.permute(0, 2, 1, 3) * fac[..., None]


def _ims(sol, tau_eval, phi):
    """Nakajima-Tanaka's secondary-scattering correction (IMS) of the
    downward streams, from the column's omega- and tau-weighted averages:
    (R, 2N, Q, P)."""
    dtype = sol.tau.dtype
    wt = sol.omega * sol.tau
    s1 = wt.sum(-1)
    omega_avg = s1 / sol.tau.sum(-1)
    s2 = (sol.f * wt).sum(-1)
    f_avg = s2 / s1
    K = sol.leg.shape[-1]
    resid = torch.cat([sol.f[..., None].expand(sol.f.shape + (sol.nleg,)), sol.leg[..., sol.nleg:]], -1)
    resid_avg = (resid * wt[..., None]).sum(1) / s2[:, None]          # (R, K)
    smu0 = sol.mu0 / (1 - omega_avg * f_avg)
    nu = _scatter_cos(-sol.mu, phi, -sol.mu0, sol.phi0)              # (R, N, P)
    x = 1 / sol.mu[None, :] - 1 / smu0[:, None]                      # (R, N)
    t = tau_eval[:, None, :]
    s0 = smu0[:, None, None]
    chi = ((t - 1 / x[..., None]) * torch.exp(-t / s0) + torch.exp(-t / sol.mu[None, :, None]) / x[..., None]) / (
        sol.mu[None, :, None] * s0 * x[..., None])                   # (R, N, Q)
    two_l1 = (2 * torch.arange(K, device=x.device) + 1).to(dtype)
    phase = legendre_series((two_l1 * (2 * resid_avg - resid_avg**2))[:, None, None, :], nu)
    ofa = omega_avg * f_avg
    ims = (sol.I0 / FOUR_PI * ofa**2 / (1 - ofa))[:, None, None, None] * phase[:, :, None, :] * chi[..., None]
    return torch.cat([torch.zeros_like(ims), ims], dim=1)


def beam_pole_distance(sol):
    """min over modes, layers and eigenvalues of |1 - k mu0| per row (R,):
    where it is small, the beam's particular solution is ill-conditioned
    in any precision."""
    return torch.abs(1.0 - sol.k * sol.mu0[:, None, None, None]).amin(dim=(1, 2, 3))


def nt_pole_distance(sol):
    """min over the streams of |1 - mu_i / mu0| (the TMS correction's pole)
    and |1 - mu_i / mu0'| (the IMS correction's, mu0' the scaled mu0 of
    `_ims`) per row (R,)."""
    wt = sol.omega * sol.tau
    s1 = wt.sum(-1)
    ofa = (s1 / sol.tau.sum(-1)) * ((sol.f * wt).sum(-1) / s1)
    d = [torch.abs(1.0 - sol.mu[None, :] / m[:, None]).amin(dim=1) for m in (sol.mu0, sol.mu0 / (1 - ofa))]
    return torch.minimum(*d)
