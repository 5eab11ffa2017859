"""Batched (columns x bands) entry points."""

from .batch import (
    actinic_at, fluxes_at, make_batched_problem, solve_actinic, solve_fluxes, solve_intensity, u0_at, u_at,
    u_corrected_at,
)
from .sweep import SweepDriver

__all__ = ["make_batched_problem", "fluxes_at", "solve_fluxes", "u0_at", "u_at", "u_corrected_at",
           "solve_intensity", "actinic_at", "solve_actinic", "SweepDriver"]
