"""Problem / solution containers for the discrete-ordinates solver.

Counterpart of ``pythonic_disort_tpu/models/disort/types.py``.  The
field names and shapes are the same, so the tests compare the two
packages field by field.  In place of pytrees the containers are plain
dataclasses of tensors.  On the batched path every tensor field carries a
leading batch axis ``S`` (columns x bands), as the shapes below show; on
the single-column path (`solve.solve`) the same fields have no ``S`` axis.

Shape conventions: ``L`` layers, ``N = nquad // 2`` streams per
hemisphere, ``NF`` Fourier modes, ``Ns`` source-polynomial coefficients,
``NB`` BDRF modes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DisortConfig:
    """Static solver configuration (frozen, hashable)."""

    nquad: int            # total streams (even); N = nquad // 2
    nleg: int             # phase-function Legendre coefficients used
    nleg_all: int         # total provided Legendre coefficients
    nfourier: int         # Fourier modes solved
    nlayers: int
    nscoeffs: int         # isotropic-source polynomial coeffs (0 = none)
    nbdrf: int            # BDRF Fourier modes (0 = none)
    has_beam: bool        # I0 > 0
    only_flux: bool = False
    nt_correct: bool = False   # apply Nakajima-Tanaka intensity corrections
    has_deltam: bool = True    # any f_arr > 0 (delta-M scaling active)

    @property
    def n(self) -> int:
        return self.nquad // 2

    @property
    def has_iso(self) -> bool:
        return self.nscoeffs > 0


@dataclasses.dataclass
class DisortProblem:
    """Numeric inputs of a batch of solves (leading axis S on every tensor)
    or of one solve (no S axis).

    ``bdrf_modes[s, m, i, j] = BDRF_m(mu_i, mu_j)`` and
    ``bdrf_modes_mu0[s, m, i] = BDRF_m(mu_i, mu0)`` are pre-evaluated on
    the quadrature grid.  ``lam_mu0`` is the associated-Legendre table at
    ``-mu0``, (S, NF, NLeg), computed on the host when the problem is
    built, or None: the batched solve then builds it on the device from
    ``mu0`` (a mu0 that takes a derivative).
    """

    config: DisortConfig
    tau_arr: torch.Tensor         # (S, L) layer lower boundaries (cumulative)
    omega_arr: torch.Tensor       # (S, L)
    leg_coeffs_all: torch.Tensor  # (S, L, nleg_all)
    f_arr: torch.Tensor           # (S, L) delta-M truncation fractions
    mu0: torch.Tensor             # (S,)
    I0: torch.Tensor              # (S,)
    phi0: torch.Tensor            # (S,)
    b_pos: torch.Tensor           # (S, N, NF) bottom Dirichlet BC by mode
    b_neg: torch.Tensor           # (S, N, NF) top Dirichlet BC by mode
    s_poly_coeffs: torch.Tensor   # (S, L, max(Ns, 1)) iso-source polynomials
    bdrf_modes: torch.Tensor      # (S, max(NB, 1), N, N)
    bdrf_modes_mu0: torch.Tensor  # (S, max(NB, 1), N)
    lam_mu0: Optional[torch.Tensor] = None   # (S, NF, NLeg)


@dataclasses.dataclass
class DisortSolution:
    """Precomputed spectral solution data of a batch of solves, or of one
    solve (no S axis; ``G`` (NF, L, 2N, 2N) and ``GC`` present).

    On the flux-only batched path ``G`` and ``GC`` are ``None``: the flux
    evaluator reads the per-layer ``fvec_*``/``fb_*``/``fi_*`` tables.
    """

    config: DisortConfig
    G: Optional[torch.Tensor]     # None on the batched path
    K: torch.Tensor               # (S, NF, L, 2N) eigenvalues (-K+ | +K+)
    GC: Optional[torch.Tensor]    # (S, NF, L, 4N^2); None when only_flux
    B: torch.Tensor               # (S, NF, L, 2N) beam particular solution
    mathscr_b: torch.Tensor       # (S, L, 2N, Ns) iso particular tensor
    tau_arr: torch.Tensor         # (S, L)
    scaled_tau_with_0: torch.Tensor   # (S, L+1)
    scale_tau: torch.Tensor       # (S, L)
    mu_arr_pos: torch.Tensor      # (S, N)
    W: torch.Tensor               # (S, N)
    mu0: torch.Tensor             # (S,)
    I0: torch.Tensor              # (S,) rescaled beam intensity
    phi0: torch.Tensor            # (S,)
    rescale_factor: torch.Tensor  # (S,)
    omega_arr: torch.Tensor       # (S, L) unscaled
    f_arr: torch.Tensor           # (S, L)
    scaled_omega_arr: torch.Tensor    # (S, L)
    weighted_leg_all: torch.Tensor    # (S, L, nleg_all)
    weighted_scaled_leg: torch.Tensor  # (S, L, nleg)
    fvec_up: torch.Tensor = None  # (S, L, 2N)
    fvec_dn: torch.Tensor = None  # (S, L, 2N)
    fb_up: torch.Tensor = None    # (S, L)
    fb_dn: torch.Tensor = None    # (S, L)
    fi_up: torch.Tensor = None    # (S, L, Ns)
    fi_dn: torch.Tensor = None    # (S, L, Ns)
