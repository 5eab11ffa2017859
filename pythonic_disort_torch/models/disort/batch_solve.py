"""Batched discrete-ordinates solve, end to end in lanes layout.

Counterpart of ``pythonic_disort_tpu/models/disort/batch_solve.py::
solve_batched``: every feature of the single-column solve (beam,
isotropic internal source, BDRF, delta-M, NFourier > 1, fluxes and
intensities) for a batch of solves.  Every tensor a kernel consumes
keeps the batch last, ``(..., Q)``, with the eigen-stage lane order
``q = (m, l, s)`` (mode-major, solve fastest), so per-mode slices are
contiguous and the reshape to the BVP layout ``(L, ..., NF*S)`` never
crosses the lane dimension:

- the phase-function kernels D+/D- are built in lanes by per-mode
  matmuls over the Legendre contraction;
- the eigen stage is `ops.eig.disort_eigh_lanes` (CUDA kernel 1 at even
  N <= 32; at other N its Cholesky + Jacobi route, CUDA kernel 5);
- the beam's pole: the particular solution divides by 1/mu0 - k for every
  eigenvalue k of a solve's (mode, layer) pairs, so right after the eigen
  stage `solve.off_pole` moves the mu0 of each solve whose least
  |1 - k mu0| lies below ``solve.POLE_GAP`` (1e-5 in float32, 1e-9 in
  float64) by 2 or 4 gaps, on the device and with no host sync.  The moved
  mu0 is the solve's from there on: the beam's Legendre table (rebuilt on
  the device and taken for the moved solves alone, so the others keep the
  host table's bits), the particular solution, the beam's decays, the
  BDRF's beam term and the solution's ``mu0``, which the evaluators and the
  NT correction read: the moved solve is exact for the moved mu0;
- the eigenvector blocks in the BVP's layout ``Gt`` and the beam's
  particular solution are `ops.operands.bvp_operands` (one launch of
  CUDA kernel ``bvp_operands.cu`` on the card);
- the BVP is `ops.cuda_blocktri.solve_bvp_fused` at every 2N, fed the
  eigenvector blocks, decays and bottom boundary rows; it routes by width
  (CUDA kernel 7 at 2N <= 64; wider systems,
  where the JAX package runs its jnp path, have their blocks assembled
  and solved by the generic block-Thomas solve, kernel 6 there);
- the flux quadrature ``(mu W) @ G C`` is folded into per-layer tables
  (``fvec_*``, ``fb_*``, ``fi_*``), so ``G`` is never materialized and
  ``GC`` only for intensity output (``only_flux=False``);
- `solve_batched_probes` contracts the intensity modes at one probe per
  layer in lanes, without ``GC``.
"""

from __future__ import annotations

import math

import torch

from ...ops.cuda_blocktri import solve_bvp_fused
from ...ops.eig import disort_eigh_lanes
from ...ops.legendre import normalized_assoc_legendre
from ...ops.operands import bvp_operands, mat_lanes, mode0_blocks
from .solve import (_power_ladder, _tables, affine_transform_poly_coeffs, iso_particular_tensor, iso_poly_eval,
                    off_pole)
from ...utils.profiling import span
from .types import DisortProblem, DisortSolution


def solve_batched(problem: DisortProblem) -> DisortSolution:
    """Solve a batch of atmospheres; all tensors carry a leading S.

    Returns a batched `DisortSolution` with ``G = None``; ``GC`` (S, NF, L,
    4N^2) is materialized for intensity output only (``only_flux=False``).
    The flux evaluator (`eval.fluxes_all`) reads the ``fvec_*``/``fb_*``/
    ``fi_*`` tables.
    """
    return _solve(problem)[0]


def solve_batched_probes(problem: DisortProblem, probe_tau: torch.Tensor):
    """Solve a batch and contract the intensity modes at one probe per layer.

    ``probe_tau`` (S, L): probe ``t`` lies in layer ``t``, (tau_{t-1},
    tau_t] (checked by `parallel.batch.solve_intensity`).  The layer
    gather of the evaluators is then the identity, so the modes are
    contracted from the lanes tensors in place and ``GC`` is never
    materialized.  Returns ``(solution, um)``; ``um`` (S, NF, 2N, L) holds
    the Fourier modes of u at the probes before the rescale factor.
    """
    return _solve(problem, probe_tau)


def _solve(problem: DisortProblem, probe_tau=None):
    """The batched solve; ``(solution, um or None)``."""
    cfg = problem.config
    N, NF, L = cfg.n, cfg.nfourier, cfg.nlayers
    NLeg, NB, Ns = cfg.nleg, cfg.nbdrf, cfg.nscoeffs

    tau_arr = problem.tau_arr                                    # (S, L)
    dtype, device = tau_arr.dtype, tau_arr.device
    with span("disort.solve.assemble", device):
        S = tau_arr.shape[0]
        omega_arr, f_arr = problem.omega_arr, problem.f_arr
        mu0, I0, phi0 = problem.mu0, problem.I0, problem.phi0        # (S,)
        tab = _tables(cfg.nquad, NLeg, cfg.nleg_all, NF, dtype, device)
        mu, w = tab.mu, tab.w
        M_inv = 1.0 / mu

        zeros_s1 = torch.zeros((S, 1), dtype=dtype, device=device)
        thickness = torch.diff(tau_arr, dim=-1, prepend=zeros_s1)
        weighted_leg_all = tab.leg_weights[None, None, :] * problem.leg_coeffs_all
        leg = problem.leg_coeffs_all[..., :NLeg]

        # ---- delta-M scaling (reference pydisort.py:313-344) ----
        if cfg.has_deltam:
            scale_tau = 1.0 - omega_arr * f_arr
            scaled_tau_with_0 = torch.cat(
                [zeros_s1, torch.cumsum(scale_tau * thickness, dim=-1)], dim=-1)
            scaled_leg = (leg - f_arr[..., None]) / (1.0 - f_arr)[..., None]
            scaled_omega = (1.0 - f_arr) / scale_tau * omega_arr
        else:
            scale_tau = torch.ones((S, L), dtype=dtype, device=device)
            scaled_tau_with_0 = torch.cat([zeros_s1, tau_arr], dim=-1)
            scaled_leg = leg
            scaled_omega = omega_arr
        weighted_scaled_leg = scaled_leg * tab.leg_weights[None, None, :NLeg]

        if cfg.has_iso:
            if cfg.has_deltam:
                tau_tops = torch.cat([zeros_s1, tau_arr[:, :-1]], dim=-1)
                translations = scaled_tau_with_0[:, :-1] - scale_tau * tau_tops
                scaled_s_poly = (
                    affine_transform_poly_coeffs(problem.s_poly_coeffs, scale_tau, translations)
                    / scale_tau[..., None]
                ) * (1.0 - omega_arr)[..., None]
            else:
                scaled_s_poly = problem.s_poly_coeffs * (1.0 - omega_arr)[..., None]

        # ---- source rescaling for conditioning (reference pydisort.py:348-373) ----
        b_pos, b_neg = problem.b_pos, problem.b_neg                  # (S, N, NF)
        candidates = [I0, b_pos.amax(dim=(1, 2)), b_neg.amax(dim=(1, 2))]
        if cfg.has_iso:
            taup = _power_ladder(scaled_tau_with_0[:, -1], Ns)      # (S, Ns), 0^0 = 1
            candidates += [scaled_s_poly[:, 0, 0], (scaled_s_poly[:, -1, :] * taup).sum(dim=-1)]
        rescale = torch.stack(candidates, dim=-1).amax(dim=-1)
        rescale = torch.where(rescale > 0, rescale, torch.ones_like(rescale))
        I0 = I0 / rescale
        b_pos = b_pos / rescale[:, None, None]
        b_neg = b_neg / rescale[:, None, None]
        I0_div_4pi = I0 / (4.0 * math.pi)

        # ---- phase-function kernels, built directly in lanes layout ----
        lam_mu, mode_mask, parity = tab.lam_mu, tab.mode_mask, tab.parity

        # base[s, l, c] = (omega_l / 2)(2c+1) g_{l,c}; per-mode masked below
        base_c = (scaled_omega[..., None] / 2.0) * weighted_scaled_leg
        LS = L * S
        base_lanes = base_c.permute(2, 1, 0).reshape(NLeg, LS)      # (NLeg, L*S)
        Dp_parts, Dm_parts = [], []
        for m in range(NF):
            lamlam = (lam_mu[m][:, :, None] * lam_mu[m][:, None, :]).reshape(NLeg, N * N)
            cm = mode_mask[m][:, None] * base_lanes
            Dp_parts.append((lamlam.T @ cm).reshape(N, N, LS))
            Dm_parts.append(((lamlam * parity[m][:, None]).T @ cm).reshape(N, N, LS))
        Dp_l = torch.stack(Dp_parts, dim=2).reshape(N, N, NF * LS)  # q = (m, l, s)
        Dm_l = torch.stack(Dm_parts, dim=2).reshape(N, N, NF * LS)

    # ---- batched eigen stage, lanes in / lanes out ----
    with span("disort.solve.eig", device):
        K_pos, X, Y, P, Q = disort_eigh_lanes(Dp_l, Dm_l, mu, w)   # (N[, N], Q)
    if cfg.has_beam:
        with span("disort.solve.pole", device):
            # each solve's mu0 moved off the beam's resonance (`off_pole`);
            # everything below reads the moved mu0
            mu0, moved = off_pole(mu0, K_pos.reshape(-1, S))
            lam_m0 = normalized_assoc_legendre(NF, NLeg, -mu0)     # (NF, NLeg, S), on the device
            if problem.lam_mu0 is not None:
                # the host's table where mu0 did not move, its bits kept
                lam_m0 = torch.where(moved, lam_m0, problem.lam_mu0.permute(1, 2, 0))
    with span("disort.solve.operands", device):
        K_full = torch.cat([-K_pos, K_pos], dim=0)                   # (2N, Q)

        def per_mode(x_sl):
            """(S, L) per-solve quantity -> (Q,) lanes (broadcast over modes)."""
            return x_sl.T[None].expand(NF, L, S).reshape(NF * LS)

        # ---- G in the BVP's L-major layout, and the beam particular solution ----
        if cfg.has_beam:
            xf_parts_p, xf_parts_n = [], []
            for m in range(NF):
                delta_m0 = 1.0 if m == 0 else 2.0
                fac = (2.0 * delta_m0) * (mode_mask[m][:, None] * base_lanes).reshape(
                    NLeg, L, S) * (I0_div_4pi[None, None, :] * lam_m0[m][:, None, :])
                fac = fac.reshape(NLeg, LS)
                xf_parts_p.append(lam_mu[m].T @ fac)                 # (N, LS)
                xf_parts_n.append(lam_mu[m].T @ (parity[m][:, None] * fac))
            Xp = torch.stack(xf_parts_p, dim=1).reshape(N, NF * LS)
            Xn = torch.stack(xf_parts_n, dim=1).reshape(N, NF * LS)
            xp, xn = M_inv[:, None] * Xp, -M_inv[:, None] * Xn
            Gt, B_l = bvp_operands(X, Y, P, Q, K_full, L, S, xp, xn, mu0)   # (L, 2N, 2N, NF*S), (2N, Q)
        else:
            Gt, _ = bvp_operands(X, Y, P, Q, K_full, L, S)
            B_l = torch.zeros((2 * N, NF * LS), dtype=dtype, device=device)

        # ---- isotropic-source particular tensor (mode 0, its LS lanes first) ----
        if cfg.has_iso:
            QM = mat_lanes(Q[..., :LS], M_inv[:, None].expand(N, LS))
            G_inv_mu_inv = torch.cat([QM, -QM], dim=0).T              # (LS, 2N)
            s_desc = (scaled_s_poly / rescale[:, None, None]).flip(-1).transpose(0, 1).reshape(LS, Ns)
            mathscr_b = iso_particular_tensor(mode0_blocks(Gt, S), K_full[:, :LS].T, G_inv_mu_inv, s_desc)
            mathscr_b = mathscr_b.reshape(L, S, 2 * N, Ns).transpose(0, 1)   # (S, L, 2N, Ns)
        else:
            mathscr_b = torch.zeros((S, L, 2 * N, 1), dtype=dtype, device=device)

        # ---- BDRF operators (reference _solve_for_coeffs.py:118-135) ----
        mu_w = mu * w
        NFS = NF * S
        R_pad = torch.zeros((S, NF, N, N), dtype=dtype, device=device)
        X_bdrf = torch.zeros((S, NF, N), dtype=dtype, device=device)
        has_bdrf = NB > 0
        if has_bdrf:
            nb = min(NB, NF)
            delta = tab.bdrf_delta[None, :nb, None, None]
            R_pad[:, :nb] = delta * problem.bdrf_modes[:, :nb] * mu_w[None, None, None, :]
            if cfg.has_beam:
                X_bdrf[:, :nb] = (4.0 * mu0 * I0_div_4pi)[:, None, None] * problem.bdrf_modes_mu0[:, :nb]
        R_l = R_pad.permute(2, 3, 1, 0).reshape(N, N, NFS)
        X_bdrf_l = X_bdrf.permute(2, 1, 0).reshape(N, NFS)

        # ---- BVP operands, L-major lanes (L, rows, cols, NF*S) ----
        sthick = scaled_tau_with_0[:, 1:] - scaled_tau_with_0[:, :-1]   # (S, L)
        decay_q = torch.exp(-K_pos * per_mode(sthick)[None, :])         # (N, Q)
        decay_t = decay_q.reshape(N, NF, L, S).permute(2, 0, 1, 3).reshape(L, N, NFS)

        # Bottom BC rows: (G_pn - R G_nn) decay | (G_pp - R G_np)
        GL = Gt[-1]
        if has_bdrf:
            bot_left = (GL[:N, :N] - torch.einsum("ijq,jkq->ikq", R_l, GL[N:, :N])) * decay_t[-1][None]
            bot_right = GL[:N, N:] - torch.einsum("ijq,jkq->ikq", R_l, GL[N:, N:])
        else:
            bot_left = GL[:N, :N] * decay_t[-1][None]
            bot_right = GL[:N, N:]
        Bt_rows = torch.cat([bot_left, bot_right], dim=1)            # (N, 2N, NFS)

        # ---- RHS (reference _solve_for_coeffs.py:139-256) ----
        B5 = B_l.reshape(2 * N, NF, L, S)
        rhs_top = b_neg.permute(1, 2, 0)                             # (N, NF, S)
        rhs_bot = b_pos.permute(1, 2, 0)
        if cfg.has_beam:
            beam_decay_bot = torch.exp(-scaled_tau_with_0[:, -1] / mu0)     # (S,)
            rhs_top = rhs_top - B5[N:, :, 0, :]
            RB = (torch.einsum("ijq,jq->iq", R_l, B5[N:, :, -1, :].reshape(N, NFS)).reshape(N, NF, S)
                  if has_bdrf else 0.0)
            rhs_bot = rhs_bot + (X_bdrf_l.reshape(N, NF, S) + RB - B5[:N, :, -1, :]) \
                * beam_decay_bot[None, None, :]
        if cfg.has_iso:
            # mode 0 only; new tensors, not writes into views of b_neg/b_pos
            v_top = iso_poly_eval(mathscr_b[:, 0], zeros_s1[:, 0])                 # (S, 2N)
            v_bot = iso_poly_eval(mathscr_b[:, -1], scaled_tau_with_0[:, -1])
            top0 = -v_top[:, N:]
            bot0 = -v_bot[:, :N]
            if has_bdrf:
                bot0 = bot0 + torch.einsum("sij,sj->si", R_pad[:, 0], v_bot[:, N:])
            rhs_top = torch.cat([rhs_top[:, :1] + top0.T[:, None], rhs_top[:, 1:]], dim=1)
            rhs_bot = torch.cat([rhs_bot[:, :1] + bot0.T[:, None], rhs_bot[:, 1:]], dim=1)
        if L > 1:
            cont_rhs = torch.zeros((L - 1, 2 * N, NF, S), dtype=dtype, device=device)
            if cfg.has_beam:
                bdecay = torch.exp(-scaled_tau_with_0[:, 1:-1] / mu0[:, None])   # (S, L-1)
                diffB = (B5[:, :, 1:, :] - B5[:, :, :-1, :]).permute(2, 0, 1, 3)
                cont_rhs = cont_rhs + diffB * bdecay.T[:, None, None, :]
            if cfg.has_iso:
                tb = scaled_tau_with_0[:, 1:-1]                                  # (S, L-1)
                jump = iso_poly_eval(mathscr_b[:, 1:], tb) - iso_poly_eval(mathscr_b[:, :-1], tb)
                cont_rhs = torch.cat([cont_rhs[:, :, :1] + jump.permute(1, 2, 0)[:, :, None],
                                      cont_rhs[:, :, 1:]], dim=2)
            rhs_t = torch.cat(
                [torch.cat([rhs_top[None], cont_rhs[:, N:]], dim=0),
                 torch.cat([cont_rhs[:, :N], rhs_bot[None]], dim=0)], dim=1,
            ).reshape(L, 2 * N, NFS)
        else:
            rhs_t = torch.cat([rhs_top, rhs_bot], dim=0).reshape(1, 2 * N, NFS)

    with span("disort.solve.bvp", device):
        C_t = solve_bvp_fused(Gt.contiguous(), decay_t.contiguous(),
                              Bt_rows.contiguous(), rhs_t.contiguous())   # (L, 2N, NFS)

    with span("disort.solve.outputs", device):
        # ---- intensity modes at one probe per layer, contracted in lanes ----
        # um[t, i, (m, s)] = sum_j G[t, i, j] C[t, j] exp(K_j dt) (+ beam, iso):
        # probe t lies in layer t, so the evaluators' layer gather is the
        # identity and the contraction reads Gt and C_t in place.
        um = None
        if probe_tau is not None:
            top_b = scaled_tau_with_0[:, :-1]                        # (S, L)
            bot_b = scaled_tau_with_0[:, 1:]
            st_b = bot_b - (tau_arr - probe_tau) * scale_tau if cfg.has_deltam else probe_tau
            Kr = K_full.reshape(2 * N, NF, L, S)
            # exponents <= 0: K[:N] < 0 anchored at the layer top, K[N:] > 0 at the bottom
            expo_b = torch.exp(torch.cat([Kr[:N] * (st_b - top_b).T[None, None],
                                          Kr[N:] * (st_b - bot_b).T[None, None]], dim=0))
            expo_t = expo_b.permute(2, 0, 1, 3).reshape(L, 2 * N, NFS)
            um5 = torch.einsum("tijq,tjq->tiq", Gt, C_t * expo_t).reshape(L, 2 * N, NF, S)
            if cfg.has_beam:
                bexp = torch.exp(-st_b / mu0[:, None]).T             # (L, S)
                um5 = um5 + B5.permute(2, 0, 1, 3) * bexp[:, None, None, :]
            if cfg.has_iso:
                v_iso = iso_poly_eval(mathscr_b, st_b).permute(1, 2, 0)   # (L, 2N, S)
                um5 = torch.cat([um5[:, :, :1] + v_iso[:, :, None], um5[:, :, 1:]], dim=2)
            um = um5.permute(3, 2, 1, 0)                              # (S, NF, 2N, L)

        # ---- flux tables: quadrature contraction folded in lanes ----
        C0 = C_t.reshape(L, 2 * N, NF, S)[:, :, 0, :]                # (L, 2N, S)
        G0t = Gt.reshape(L, 2 * N, 2 * N, NF, S)[..., 0, :]          # (L, 2N, 2N, S)
        fvec_up = (torch.einsum("i,lijs->ljs", mu_w, G0t[:, :N]) * C0).permute(2, 0, 1)
        fvec_dn = (torch.einsum("i,lijs->ljs", mu_w, G0t[:, N:]) * C0).permute(2, 0, 1)
        fb_up = torch.einsum("i,ils->sl", mu_w, B5[:N, 0])           # (S, L)
        fb_dn = torch.einsum("i,ils->sl", mu_w, B5[N:, 0])

        # GC for the general intensity evaluators, stored layer-flattened
        # (S, NF, L, 4N^2); not on the flux-only path nor with probes
        GC = None
        if not cfg.only_flux and probe_tau is None:
            GC5 = Gt.reshape(L, 2 * N, 2 * N, NF, S) * C_t.reshape(L, 1, 2 * N, NF, S)
            GC = GC5.permute(4, 3, 0, 1, 2).reshape(S, NF, L, 4 * N * N)

        return DisortSolution(
            config=cfg,
            G=None,
            K=K_full.reshape(2 * N, NF, L, S).permute(3, 1, 2, 0),
            GC=GC,
            B=B5.permute(3, 1, 2, 0),                                # (S, NF, L, 2N)
            mathscr_b=mathscr_b,
            tau_arr=tau_arr,
            scaled_tau_with_0=scaled_tau_with_0,
            scale_tau=scale_tau,
            mu_arr_pos=mu[None].expand(S, N),
            W=w[None].expand(S, N),
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
            fb_up=fb_up,
            fb_dn=fb_dn,
            fi_up=torch.einsum("i,slik->slk", mu_w, mathscr_b[:, :, :N]),
            fi_dn=torch.einsum("i,slik->slk", mu_w, mathscr_b[:, :, N:]),
        ), um
