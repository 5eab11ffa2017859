"""Plain float64 discrete-ordinates solver: the benchmark's reference.

A straightforward NumPy implementation of the problem the port solves
(Stamnes et al. 1988; the conventions of PythonicDISORT): a plane-parallel
column of layers with delta-M scaling, a collimated beam, an isotropic
internal source linear in tau, Dirichlet boundaries and no surface
reflection, solved mode by mode in azimuth.  It shares no code with the
port.  Per (row, mode, layer) the homogeneous system is reduced to the
N x N eigenproblem (alpha - beta)(alpha + beta); the particular solutions
are direct solves; the boundary-value problem of every (row, mode) is one
banded LU solve with partial pivoting (LAPACK ``gbsv``); the
Nakajima-Tanaka TMS correction integrates the single scatter exactly,
layer by layer.

``rnd`` is applied to every stage's result: the identity for the
reference, and a rounding to a lower precision for the control
(`tf32_round`), which is then this same algorithm computed in that
precision.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.linalg import solve_banded

FOUR_PI = 4.0 * math.pi


def identity(x):
    return x


def tf32_round(x):
    """``x`` rounded to TF32 (float32's exponent, a 10-bit mantissa),
    round half to even, returned as float64."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return b.view(np.float32).astype(np.float64)


def float32_round(x):
    """``x`` rounded to float32, returned as float64."""
    return np.asarray(x, dtype=np.float32).astype(np.float64)


# the control of a configuration's precision: the nearest one below it
LOWER = {"float64": float32_round, "float32": tf32_round}


def double_gauss(nquad):
    """``nquad // 2`` Gauss-Legendre nodes on (0, 1), ascending, and weights."""
    x, w = np.polynomial.legendre.leggauss(nquad // 2)
    return 0.5 * (x + 1.0), 0.5 * w


def assoc_legendre(nf, nleg, x):
    """Normalized associated Legendre functions
    sqrt((l-m)!/(l+m)!) P_l^m(x), for m < nf, l < nleg; (nf, nleg, *x.shape),
    zero where l < m."""
    x = np.asarray(x, np.float64)
    out = np.zeros((nf, nleg) + x.shape)
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    for m in range(min(nf, nleg)):
        # Lambda_m^m = (-1)^m sqrt((2m)!) / (2^m m!) s^m, by a stable product
        c = 1.0
        for k in range(1, m + 1):
            c *= -math.sqrt((2 * k - 1) / (2 * k))
        out[m, m] = c * s**m
        if m + 1 < nleg:
            out[m, m + 1] = math.sqrt(2 * m + 1) * x * out[m, m]
        for l in range(m + 2, nleg):
            out[m, l] = ((2 * l - 1) * x * out[m, l - 1]
                         - math.sqrt((l - 1) ** 2 - m * m) * out[m, l - 2]) / math.sqrt(l * l - m * m)
    return out


def legendre_series(coeffs, x):
    """sum_k coeffs[..., k] P_k(x) by the three-term recurrence; ``coeffs``
    (..., K) broadcasts against ``x``."""
    p0, p1 = np.ones_like(x), x
    total = coeffs[..., 0] * p0
    if coeffs.shape[-1] > 1:
        total = total + coeffs[..., 1] * p1
    for k in range(2, coeffs.shape[-1]):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        total = total + coeffs[..., k] * p1
    return total


class Solution:
    """Per (row, mode, layer) eigen data, particular solutions and BVP
    coefficients of a batch of rows; evaluated by `fluxes` and `intensity`."""


def solve(tau, omega, leg, f, mu0, I0, phi0, nquad, nleg, nfourier, s_poly=None, b_pos=None,
          has_beam=True, rnd=identity):
    """Solve R rows.  ``tau`` (R, L) cumulative layer bottoms, ``omega``,
    ``f`` (R, L), ``leg`` (R, L, K) Legendre coefficients of the phase
    function (``leg[..., 0] = 1``), ``mu0``, ``I0``, ``phi0`` (R,);
    ``s_poly`` (R, L, 2) isotropic source ``a + b tau`` in each layer (in
    unscaled tau); ``b_pos`` (R,) isotropic upward intensity at the bottom
    (mode 0).  Returns a `Solution`."""
    tau, omega, leg, f = (rnd(np.asarray(a, np.float64)) for a in (tau, omega, leg, f))
    mu0, I0, phi0 = (rnd(np.asarray(a, np.float64)) for a in (mu0, I0, phi0))
    R, L = tau.shape
    N, NF = nquad // 2, nfourier
    thick = np.diff(tau, axis=1, prepend=0.0)
    scale = 1.0 - omega * f
    t_bot = np.cumsum(scale * thick, axis=1)
    t_w0 = np.concatenate([np.zeros((R, 1)), t_bot], axis=1)
    leg_s = (leg[:, :, :nleg] - f[..., None]) / (1.0 - f[..., None])
    omega_s = (1.0 - f) * omega / scale

    mu, w = double_gauss(nquad)
    lam = assoc_legendre(NF, nleg, mu)                              # (M, K, N)
    ks = np.arange(nleg)
    ms = np.arange(NF)
    mask = (ks[None, :] >= ms[:, None]).astype(np.float64)          # (M, K)
    parity = np.where(mask > 0, (-1.0) ** (ks[None, :] - ms[:, None]), 0.0)
    c = 0.5 * omega_s[..., None] * (2 * ks + 1) * leg_s              # (R, L, K)
    cm = c[:, None] * mask[None, :, None, :]                         # (R, M, L, K)
    Dp = np.einsum("rmlk,mki,mkj->rmlij", cm, lam, lam, optimize=True)
    Dm = np.einsum("rmlk,mki,mkj->rmlij", cm * parity[None, :, None, :], lam, lam, optimize=True)
    Minv = 1.0 / mu
    alpha = rnd(Minv[:, None] * (np.eye(N) - Dp * w))                # M^-1 (I - D+ W)
    beta = rnd(-Minv[:, None] * (Dm * w))                            # -M^-1 D- W

    # homogeneous: lambda^2 u = (alpha - beta)(alpha + beta) u, v = (alpha + beta) u / lambda
    apb = alpha + beta
    k2, U = np.linalg.eig((alpha - beta) @ apb)
    k = rnd(np.sqrt(np.abs(k2.real)))
    U = U.real
    APU = apb @ U
    v = APU / k[..., None, :]
    Vdec = rnd(np.concatenate([U - v, U + v], axis=-2) * 0.5)        # eigenvalue -k (decays downward)
    Vinc = rnd(np.concatenate([U + v, U - v], axis=-2) * 0.5)        # eigenvalue +k

    A = np.concatenate([np.concatenate([alpha, beta], -1), np.concatenate([-beta, -alpha], -1)], -2)
    sol = Solution()
    sol.beam = None
    if has_beam:
        lam0 = assoc_legendre(NF, nleg, -mu0)                        # (M, K, R)
        delta = np.where(ms == 0, 1.0, 2.0)
        X = 2.0 * np.einsum("rmlk,mki,mkr->rmli", cm, lam, lam0) * (delta[None, :, None, None]
                                                                     * (I0 / FOUR_PI)[:, None, None, None])
        Xn = 2.0 * np.einsum("rmlk,mki,mkr->rmli", cm * parity[None, :, None, :], lam, lam0) * (
            delta[None, :, None, None] * (I0 / FOUR_PI)[:, None, None, None])
        rhs = np.concatenate([Minv * X, -Minv * Xn], axis=-1)
        lhs = A + np.eye(2 * N) / mu0[:, None, None, None, None]
        sol.beam = rnd(np.linalg.solve(lhs, rhs[..., None])[..., 0])  # (R, M, L, 2N) times exp(-t/mu0)
    sol.iso = None
    if s_poly is not None:
        s_poly = rnd(np.asarray(s_poly, np.float64))
        tops = np.concatenate([np.zeros((R, 1)), tau[:, :-1]], axis=1)
        q0 = (1.0 - omega_s) * (s_poly[..., 0] + s_poly[..., 1] * tops)
        q1 = (1.0 - omega_s) * s_poly[..., 1] / scale
        S1 = np.concatenate([Minv, -Minv])
        A0 = A[:, 0]
        Y1 = np.linalg.solve(A0, (S1 * q1[..., None])[..., None])[..., 0]
        Y0 = np.linalg.solve(A0, (Y1 + S1 * q0[..., None])[..., None])[..., 0]
        sol.iso = (rnd(Y0), rnd(Y1))                                 # mode 0: Y0 + Y1 (t - t_top)

    sol.__dict__.update(R=R, L=L, N=N, NF=NF, nleg=nleg, mu=mu, w=w, tau=tau, omega=omega, leg=leg, f=f,
                        leg_s=leg_s, omega_s=omega_s, scale=scale, t_w0=t_w0, mu0=mu0, I0=I0, phi0=phi0,
                        k=k, Vdec=Vdec, Vinc=Vinc, has_beam=has_beam)
    sol.C = _bvp(sol, b_pos, rnd)
    return sol


def _particular(sol, l, t):
    """Particular solution of layer ``l`` (R, Q) at scaled depths ``t`` (R, Q):
    (R, M, Q, 2N)."""
    R, N, NF = sol.R, sol.N, sol.NF
    out = np.zeros((R, NF, t.shape[1], 2 * N))
    rr = np.arange(R)[:, None]
    if sol.beam is not None:
        out += sol.beam[rr, :, l].transpose(0, 2, 1, 3) * np.exp(-t / sol.mu0[:, None])[:, None, :, None]
    if sol.iso is not None:
        Y0, Y1 = sol.iso
        s = t - sol.t_w0[rr, l]
        out[:, 0] += Y0[rr, l] + Y1[rr, l] * s[..., None]
    return out


def _homogeneous(sol, l, t):
    """The 2N homogeneous basis solutions of layer ``l`` at scaled depths
    ``t``: (R, M, Q, 2N rows, 2N columns), columns [decaying | growing]."""
    rr = np.arange(sol.R)[:, None]
    top, bot = sol.t_w0[rr, l], sol.t_w0[rr, l + 1]
    k = sol.k[rr, :, l].transpose(0, 2, 1, 3)                        # (R, M, Q, N)
    e_dec = np.exp(-k * (t - top)[:, None, :, None])
    e_inc = np.exp(-k * (bot - t)[:, None, :, None])
    Vd = sol.Vdec[rr, :, l].transpose(0, 2, 1, 3, 4)
    Vi = sol.Vinc[rr, :, l].transpose(0, 2, 1, 3, 4)
    return np.concatenate([Vd * e_dec[..., None, :], Vi * e_inc[..., None, :]], axis=-1)


def _bvp(sol, b_pos, rnd):
    """Coefficients (R, M, L, 2N) of the homogeneous solutions: continuity
    at every interface, the top's downward intensities zero (no diffuse
    incidence), the bottom's upward ones ``b_pos`` (mode 0)."""
    R, L, N, NF = sol.R, sol.L, sol.N, sol.NF
    n2, n = 2 * N, 2 * N * L
    bw = 3 * N - 1
    ab = np.zeros((R, NF, 2 * bw + 1, n))
    rhs = np.zeros((R, NF, n))
    ones = np.ones((R, 1), np.int64)

    def put(row0, col0, block):
        # block (R, M, P rows, 2N columns) at rows row0.., columns col0..
        P = block.shape[-2]
        i = row0 + np.arange(P)[:, None]
        j = col0 + np.arange(n2)[None, :]
        ab[:, :, bw + i - j, j] = block

    t0 = sol.t_w0[:, :1]
    H0 = _homogeneous(sol, 0 * ones, t0)[:, :, 0]                    # (R, M, 2N, 2N)
    P0 = _particular(sol, 0 * ones, t0)[:, :, 0]
    put(0, 0, H0[:, :, N:])
    rhs[:, :, :N] = -P0[:, :, N:]
    for l in range(L - 1):
        tb = sol.t_w0[:, l + 1:l + 2]
        Ha = _homogeneous(sol, l * ones, tb)[:, :, 0]
        Hb = _homogeneous(sol, (l + 1) * ones, tb)[:, :, 0]
        row0 = N + n2 * l
        put(row0, n2 * l, Ha)
        put(row0, n2 * (l + 1), -Hb)
        rhs[:, :, row0:row0 + n2] = (_particular(sol, (l + 1) * ones, tb) - _particular(sol, l * ones, tb))[:, :, 0]
    tL = sol.t_w0[:, L:]
    HL = _homogeneous(sol, (L - 1) * ones, tL)[:, :, 0]
    PL = _particular(sol, (L - 1) * ones, tL)[:, :, 0]
    put(n - N, n2 * (L - 1), HL[:, :, :N])
    rhs[:, :, n - N:] = -PL[:, :, :N]
    if b_pos is not None:
        rhs[:, 0, n - N:] += rnd(np.asarray(b_pos, np.float64))[:, None]
    ab, rhs = rnd(ab), rnd(rhs)
    C = np.empty((R, NF, n))
    for r in range(R):
        for m in range(NF):
            C[r, m] = solve_banded((bw, bw), ab[r, m], rhs[r, m], check_finite=False)
    return rnd(C.reshape(R, NF, L, n2))


def _layer_of(sol, tau_eval):
    """Layer of each probe, tau in (tau_{l-1}, tau_l] (tau = 0 in layer 0),
    and its scaled depth."""
    l = np.minimum((sol.tau[:, None, :] < tau_eval[..., None]).sum(-1), sol.L - 1)
    rr = np.arange(sol.R)[:, None]
    t = sol.t_w0[rr, l + 1] - (sol.tau[rr, l] - tau_eval) * sol.scale[rr, l]
    return l, t


def modes_at(sol, tau_eval, rnd=identity):
    """Intensity Fourier modes (R, M, Q, 2N) at unscaled ``tau_eval`` (R, Q)."""
    l, t = _layer_of(sol, tau_eval)
    rr = np.arange(sol.R)[:, None]
    H = _homogeneous(sol, l, t)
    C = sol.C[rr, :, l].transpose(0, 2, 1, 3)                        # (R, M, Q, 2N)
    return rnd(np.einsum("rmqij,rmqj->rmqi", H, C) + _particular(sol, l, t))


def fluxes(sol, tau_eval, rnd=identity):
    """(flux_up, flux_down_diffuse, flux_down_direct), each (R, Q)."""
    tau_eval = np.asarray(tau_eval, np.float64)
    u0 = modes_at(sol, tau_eval, rnd)[:, 0]
    N = sol.N
    muw = sol.mu * sol.w
    up = 2 * math.pi * (u0[..., :N] @ muw)
    dn = 2 * math.pi * (u0[..., N:] @ muw)
    direct = np.zeros_like(tau_eval)
    if sol.has_beam:
        _, t = _layer_of(sol, tau_eval)
        mu0 = sol.mu0[:, None]
        direct = sol.I0[:, None] * mu0 * np.exp(-tau_eval / mu0)
        dn = dn + sol.I0[:, None] * mu0 * np.exp(-t / mu0) - direct
    return rnd(up), rnd(dn), rnd(direct)


def intensity(sol, tau_eval, phi, nt_correct=False, rnd=identity):
    """u (R, 2N, Q, P) at ``tau_eval`` (R, Q) and azimuths ``phi`` (R, P):
    the modes' cosine series, plus the Nakajima-Tanaka TMS and IMS
    corrections with ``nt_correct``."""
    tau_eval = np.asarray(tau_eval, np.float64)
    phi = np.asarray(phi, np.float64)
    um = modes_at(sol, tau_eval, rnd)                                # (R, M, Q, 2N)
    cos = np.cos(np.arange(sol.NF)[None, :, None] * (sol.phi0[:, None, None] - phi[:, None, :]))
    u = np.einsum("rmqi,rmp->riqp", um, cos)
    if nt_correct:
        u = u + _tms(sol, tau_eval, phi) + _ims(sol, tau_eval, phi)
    return rnd(u)


def _scatter_cos(mu, phi, mu_in, phi_in):
    """cos of the angle between directions (mu, phi) and (mu_in, phi_in):
    (R, len(mu), P) for mu (I,), phi (R, P), mu_in and phi_in (R,)."""
    return (mu_in[:, None, None] * mu[None, :, None]
            + np.sqrt(1 - mu_in**2)[:, None, None] * np.sqrt(1 - mu**2)[None, :, None]
            * np.cos(phi_in[:, None] - phi)[:, None, :])


def _tms(sol, tau_eval, phi):
    """Exact-minus-truncated single scattering of the beam (TMS), summed
    over the layers a stream crosses: (R, 2N, Q, P).  As PythonicDISORT
    does, every crossed layer's scattering is weighted by the albedo and
    phase-function difference of the probe's own layer."""
    R, L, N = sol.R, sol.L, sol.N
    mu = np.concatenate([sol.mu, -sol.mu])
    nu = _scatter_cos(mu, phi, -sol.mu0, sol.phi0)                   # (R, 2N, P)
    K = sol.leg.shape[-1]
    full = (2 * np.arange(K) + 1) * sol.leg                          # (R, L, K)
    trunc = (2 * np.arange(sol.nleg) + 1) * sol.leg_s
    p_full = legendre_series(full[:, :, None, None, :], nu[:, None])  # (R, L, 2N, P)
    p_trunc = legendre_series(trunc[:, :, None, None, :], nu[:, None])
    mu0 = sol.mu0[:, None, None, None]
    Bl = ((sol.omega_s * sol.I0[:, None] / FOUR_PI)[:, :, None, None] * (mu0 / (mu0 + mu[None, None, :, None]))
          * (p_full / (1 - sol.f)[:, :, None, None] - p_trunc))       # (R, L, 2N, P)
    l, t = _layer_of(sol, tau_eval)                                  # (R, Q)
    Bq = Bl[np.arange(R)[:, None], l]                                # (R, Q, 2N, P)
    top, bot = sol.t_w0[:, :-1], sol.t_w0[:, 1:]                     # (R, L)
    m0 = sol.mu0[:, None, None, None]
    mi = sol.mu[None, :, None, None]
    tq = t[:, None, :, None]                                         # (R, 1, Q, 1)
    # upward: layers j whose part below t is crossed, a = max(t, top_j), b = bot_j
    a = np.maximum(tq, top[:, None, None, :])
    b = bot[:, None, None, :]
    # every exponent of a crossed layer is <= 0; the clip keeps the others finite
    ex = lambda z: np.exp(np.minimum(z, 0.0))
    up = np.where(b > tq, ex(-(a - tq) / mi - a / m0) - ex(-(b - tq) / mi - b / m0), 0.0)   # (R, N, Q, L)
    # downward: a = top_j, b = min(t, bot_j)
    a = top[:, None, None, :]
    b = np.minimum(tq, bot[:, None, None, :])
    dn = np.where(a < tq, ex(-(tq - b) / mi - b / m0) - ex(-(tq - a) / mi - a / m0), 0.0)
    fac = np.concatenate([up, dn], axis=1).sum(-1)                   # (R, 2N, Q)
    return Bq.transpose(0, 2, 1, 3) * fac[..., None]


def _ims(sol, tau_eval, phi):
    """Nakajima-Tanaka's secondary-scattering correction (IMS) of the
    downward streams, from the column's omega- and tau-weighted averages:
    (R, 2N, Q, P)."""
    R, N = sol.R, sol.N
    wt = sol.omega * sol.tau
    s1 = wt.sum(-1)
    omega_avg = s1 / sol.tau.sum(-1)
    s2 = (sol.f * wt).sum(-1)
    f_avg = s2 / s1
    K = sol.leg.shape[-1]
    resid = np.concatenate([np.broadcast_to(sol.f[..., None], sol.f.shape + (sol.nleg,)), sol.leg[..., sol.nleg:]], -1)
    resid_avg = (resid * wt[..., None]).sum(1) / s2[:, None]          # (R, K)
    smu0 = sol.mu0 / (1 - omega_avg * f_avg)
    nu = _scatter_cos(-sol.mu, phi, -sol.mu0, sol.phi0)              # (R, N, P)
    x = 1 / sol.mu[None, :] - 1 / smu0[:, None]                      # (R, N)
    t = tau_eval[:, None, :]
    s0 = smu0[:, None, None]
    chi = ((t - 1 / x[..., None]) * np.exp(-t / s0) + np.exp(-t / sol.mu[None, :, None]) / x[..., None]) / (
        sol.mu[None, :, None] * s0 * x[..., None])                   # (R, N, Q)
    phase = legendre_series(((2 * np.arange(K) + 1) * (2 * resid_avg - resid_avg**2))[:, None, None, :], nu)
    ofa = omega_avg * f_avg
    ims = (sol.I0 / FOUR_PI * ofa**2 / (1 - ofa))[:, None, None, None] * phase[:, :, None, :] * chi[..., None]
    return np.concatenate([np.zeros_like(ims), ims], axis=1)


def beam_pole_distance(sol):
    """min over modes, layers and eigenvalues of |1 - k mu0| per row (R,):
    where it is small, the beam's particular solution is ill-conditioned
    in any precision."""
    return np.abs(1.0 - sol.k * sol.mu0[:, None, None, None]).min(axis=(1, 2, 3))


def nt_pole_distance(sol):
    """min over the streams of |1 - mu_i / mu0| (the TMS correction's pole)
    and |1 - mu_i / mu0'| (the IMS correction's, mu0' the scaled mu0 of
    `_ims`) per row (R,)."""
    wt = sol.omega * sol.tau
    s1 = wt.sum(-1)
    ofa = (s1 / sol.tau.sum(-1)) * ((sol.f * wt).sum(-1) / s1)
    d = [np.abs(1.0 - sol.mu[None, :] / m[:, None]).min(axis=1) for m in (sol.mu0, sol.mu0 / (1 - ofa))]
    return np.minimum(*d)
