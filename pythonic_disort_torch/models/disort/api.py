"""Reference-compatible public API: ``pydisort(...)`` returning closures.

Counterpart of ``pythonic_disort_tpu/models/disort/api.py``: a thin
host-side layer over `solve.solve` and `eval`: input canonicalization,
the reference's validation checks with the same error and warning
messages (reference ``pydisort.py:221-292``), BDRF callable sampling, and
the closures (`closures`).  The problem is built on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ...ops.quadrature import double_gauss
from ...parallel.batch import _device
from . import closures
from .nt import make_corrected_u
from .solve import solve
from .types import DisortConfig, DisortProblem

__all__ = ["pydisort", "build_problem"]


def build_problem(
    tau_arr, omega_arr,
    NQuad,
    Leg_coeffs_all,
    mu0, I0, phi0,
    NLeg=None,
    NFourier=None,
    b_pos=0,
    b_neg=0,
    only_flux=False,
    f_arr=0,
    NT_cor=False,
    BDRF_Fourier_modes=[],
    s_poly_coeffs=np.array([[]]),
    dtype=None,
    device=None,
):
    """Validate inputs and build a (config, problem) pair on ``device``.

    Semantics (defaults, shape conventions, validation messages) follow
    reference ``pydisort.py:182-299``.  ``dtype=None`` is float64;
    ``device=None`` is ``cuda``, which raises without a card.
    """
    if dtype is None:
        dtype = torch.float64
    device = _device(device)

    tau_arr = np.atleast_1d(np.asarray(tau_arr, dtype=np.float64))
    omega_arr = np.atleast_1d(np.asarray(omega_arr, dtype=np.float64))
    Leg_coeffs_all = np.atleast_2d(np.asarray(Leg_coeffs_all, dtype=np.float64))
    s_poly_coeffs = np.atleast_2d(np.asarray(s_poly_coeffs, dtype=np.float64))
    f_arr = np.atleast_1d(np.asarray(f_arr, dtype=np.float64))

    if NLeg is None:
        NLeg = NQuad
    if only_flux:
        NFourier = 1
    elif NFourier is None:
        NFourier = NQuad
    if np.all(b_pos == 0):
        b_pos = 0
    if np.all(b_neg == 0):
        b_neg = 0
    Nscoeffs = 0 if np.all(s_poly_coeffs == 0) else s_poly_coeffs.shape[1]
    NLayers = len(tau_arr)
    thickness_arr = np.diff(tau_arr, prepend=0.0)
    NLeg_all = Leg_coeffs_all.shape[1]
    N = NQuad // 2
    there_is_beam_source = I0 > 0
    there_is_iso_source = Nscoeffs > 0

    # ---- validation (messages match reference pydisort.py:221-292) ----
    if not np.all(tau_arr > 0):
        raise ValueError("tau values cannot be non-positive.")
    if not np.all(thickness_arr > 0):
        raise ValueError("Layer thicknesses cannot be non-positive.")
    if not (np.all(omega_arr >= 0) and np.all(omega_arr < 1)):
        raise ValueError(
            "Single-scattering albedo must be between 0 and 1, excluding 1."
        )
    if not NLeg > 0:
        raise ValueError(
            "The number of phase function Legendre coefficients must be positive."
        )
    if not NLeg <= NLeg_all:
        raise ValueError(
            "`NLeg` cannot be larger than the number of phase function Legendre coefficients provided."
        )
    if not Leg_coeffs_all.shape[0] == NLayers:
        raise ValueError(
            "The zeroth dimension of the shape of `Leg_coeffs_all` does not match the number of layers which is deduced from the length of `tau_arr`."
        )
    if not len(omega_arr) == NLayers:
        raise ValueError(
            "The zeroth dimension of the shape of `omega_arr` does not match the number of layers which is deduced from the length of `tau_arr`."
        )
    if np.any(f_arr != 0) and not len(f_arr) == NLayers:
        raise ValueError(
            "The length of `f_arr` does not match the number of layers which is deduced from the length of `tau_arr`."
        )
    if there_is_iso_source and not s_poly_coeffs.shape[0] == NLayers:
        raise ValueError(
            "The zeroth dimension of the shape of `s_poly_coeffs` does not match the number of layers which is deduced from the length of `tau_arr`."
        )
    if not np.all(omega_arr * Leg_coeffs_all[:, 0] == omega_arr):
        warnings.warn(
            "The zeroth index phase function Legendre coefficient must be, and has been corrected to, 1."
        )
        Leg_coeffs_all[:, 0] = 1
    if not (
        np.all(-1 < Leg_coeffs_all[:, 1:]) and np.all(Leg_coeffs_all[:, 1:] < 1)
    ):
        raise ValueError(
            "The phase function Legendre coefficients must all be between -1 and 1 exclusive (only the zeroth coefficient can equal 1)."
        )
    if not NQuad >= 2:
        raise ValueError("There must be at least two streams.")
    if not NQuad % 2 == 0:
        raise ValueError("The number of streams must be even.")
    if not NFourier > 0:
        raise ValueError(
            "The number of Fourier modes to use in the solution must be positive."
        )
    if not NFourier <= NLeg:
        raise ValueError(
            "The number of Fourier modes to use in the solution must be less than or equal to the number of phase function Legendre coefficients used."
        )
    if NFourier > 64 and not only_flux:
        warnings.warn(
            "`NFourier` is large and may cause errors, consider decreasing `NFourier` to 64 and it probably should be even less. By default `NFourier` equals `NQuad`."
        )
    if not NLeg <= NQuad:
        raise ValueError(
            "There should be more streams than the number of phase function Legendre coefficients used."
        )
    if I0 < 0:
        raise ValueError("The intensity of the incident beam cannot be negative.")
    if there_is_beam_source:
        if not (0 < mu0 and mu0 <= 1):
            raise ValueError(
                "The cosine of the polar angle of the incident beam must be between 0 and 1, excluding 0."
            )
        if not (0 <= phi0 and phi0 < 2 * math.pi):
            raise ValueError(
                "Provide the principal azimuthal angle for the incident beam (must be between 0 and 2pi, excluding 2pi)."
            )

    b_pos_arr = _canonicalize_bc(b_pos, N, NFourier, "bottom")
    b_neg_arr = _canonicalize_bc(b_neg, N, NFourier, "top")

    if not (np.all(0 <= f_arr) and np.all(f_arr <= 1)):
        raise ValueError("The fractional scattering must be between 0 and 1.")
    if Nscoeffs > 10:
        # factorial growth in the particular-solution triangle
        # (reference subroutines.py:823-824)
        warnings.warn("`Nscoeffs` is large and may cause instability.")

    mu_arr_pos, _ = double_gauss(NQuad)
    if NT_cor and np.any(np.abs(mu_arr_pos - mu0) < 1e-8):
        raise ValueError(
            "Some quadrature angles come too close to `mu0`. Perturb `NQuad` or `mu0` to rectify this error."
        )

    has_deltam = bool(np.any(f_arr > 0))
    if len(f_arr) != NLayers:
        f_arr = np.broadcast_to(f_arr, (NLayers,)).copy()

    # Numerical-stability warnings on the delta-scaled quantities
    # (reference pydisort.py:340-344), computed host-side.
    if has_deltam:
        scale_tau_np = 1 - omega_arr * f_arr
        scaled_omega_np = (1 - f_arr) / scale_tau_np * omega_arr
        scaled_leg_np = (Leg_coeffs_all[:, :NLeg] - f_arr[:, None]) / (
            1 - f_arr
        )[:, None]
    else:
        scaled_omega_np = omega_arr
        scaled_leg_np = Leg_coeffs_all[:, :NLeg]
    if np.any(scaled_omega_np > 1 - 1e-6):
        warnings.warn(
            "Some delta-scaled single-scattering albedos are very close to 1 which may cause numerical instability."
        )
    if np.any(-0.95 > scaled_leg_np[:, 1:]) or np.any(scaled_leg_np[:, 1:] > 0.95):
        warnings.warn(
            "Some delta-scaled phase function Legendre coefficients have a magnitude that is very close to 1"
            + " (this excludes the zeroth index coefficient which must be 1) which may cause numerical instability."
        )

    NBDRF = len(BDRF_Fourier_modes)
    bdrf_modes = np.zeros((max(NBDRF, 1), N, N))
    bdrf_modes_mu0 = np.zeros((max(NBDRF, 1), N))
    for m in range(NBDRF):
        mode = BDRF_Fourier_modes[m]
        if np.isscalar(mode):
            bdrf_modes[m] = mode
            bdrf_modes_mu0[m] = mode
        else:
            bdrf_modes[m] = np.asarray(mode(mu_arr_pos, mu_arr_pos))
            if there_is_beam_source:
                bdrf_modes_mu0[m] = np.asarray(
                    mode(mu_arr_pos, np.array([mu0]))
                )[:, 0]

    nt_active = bool(
        NT_cor
        and not only_flux
        and there_is_beam_source
        and np.any(f_arr > 0)
        and NLeg < NLeg_all
        and np.any(omega_arr > 0)
    )

    config = DisortConfig(
        nquad=NQuad,
        nleg=NLeg,
        nleg_all=NLeg_all,
        nfourier=NFourier,
        nlayers=NLayers,
        nscoeffs=Nscoeffs,
        nbdrf=NBDRF,
        has_beam=bool(there_is_beam_source),
        only_flux=bool(only_flux),
        nt_correct=nt_active,
        has_deltam=has_deltam,
    )
    tensor = lambda x: torch.tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    problem = DisortProblem(
        config=config,
        tau_arr=tensor(tau_arr),
        omega_arr=tensor(omega_arr),
        leg_coeffs_all=tensor(Leg_coeffs_all),
        f_arr=tensor(f_arr),
        mu0=tensor(mu0),
        I0=tensor(I0),
        phi0=tensor(phi0),
        b_pos=tensor(b_pos_arr),
        b_neg=tensor(b_neg_arr),
        s_poly_coeffs=tensor(s_poly_coeffs if Nscoeffs > 0 else np.zeros((NLayers, 1))),
        bdrf_modes=tensor(bdrf_modes),
        bdrf_modes_mu0=tensor(bdrf_modes_mu0),
    )
    return config, problem


def _canonicalize_bc(b, N, NFourier, which):
    """Scalar / vector / matrix Dirichlet BC -> (N, NFourier) array."""
    b_arr = np.atleast_1d(np.asarray(b, dtype=np.float64))
    out = np.zeros((N, NFourier))
    if b_arr.ndim == 1 and b_arr.size == 1:
        out[:, 0] = b_arr[0]
    elif b_arr.ndim == 1 and b_arr.size == N:
        out[:, 0] = b_arr
    elif b_arr.shape == (N, NFourier):
        out = b_arr
    else:
        raise ValueError(
            "The shape of the bottom boundary condition is incorrect."
            if which == "bottom"
            else "The shape of the top boundary condition is incorrect."
        )
    return out


def pydisort(
    tau_arr, omega_arr,
    NQuad,
    Leg_coeffs_all,
    mu0, I0, phi0,
    NLeg=None,
    NFourier=None,
    b_pos=0,
    b_neg=0,
    only_flux=False,
    f_arr=0,
    NT_cor=False,
    BDRF_Fourier_modes=[],
    s_poly_coeffs=np.array([[]]),
    use_banded_solver_NLayers=10,
    autograd_compatible=False,
    dtype=None,
    device=None,
):
    """Solve the 1D RTE; returns ``(mu_arr, flux_up, flux_down, u0[, u])``.

    Drop-in equivalent of reference ``pydisort.py:13-128``: same argument
    semantics, same closure-style returns, plus ``dtype`` (float64 unless
    given) and ``device`` (``cuda`` unless given; ``"cpu"`` runs the plain
    versions of the kernels).  ``use_banded_solver_NLayers`` and
    ``autograd_compatible`` are accepted for compatibility: one
    block-tridiagonal path covers all layer counts.
    """
    if not use_banded_solver_NLayers >= 3:
        raise ValueError(
            "The minimum threshold `use_banded_solver_NLayers` is 3, else the matrix will not be banded."
        )
    config, problem = build_problem(
        tau_arr, omega_arr, NQuad, Leg_coeffs_all, mu0, I0, phi0,
        NLeg=NLeg, NFourier=NFourier, b_pos=b_pos, b_neg=b_neg,
        only_flux=only_flux, f_arr=f_arr, NT_cor=NT_cor,
        BDRF_Fourier_modes=BDRF_Fourier_modes, s_poly_coeffs=s_poly_coeffs,
        dtype=dtype, device=device,
    )
    sol = solve(problem)
    mu_arr_pos, _ = double_gauss(NQuad)
    mu_arr = np.concatenate([mu_arr_pos, -mu_arr_pos])
    probes = closures.Probes(sol)
    outputs = (mu_arr, closures.flux_up_closure(sol, probes), closures.flux_down_closure(sol, probes),
               closures.u0_closure(sol, probes))
    if only_flux:
        return outputs
    u = make_corrected_u(sol, probes) if config.nt_correct else closures.u_closure(sol, probes)
    return outputs + (u,)
