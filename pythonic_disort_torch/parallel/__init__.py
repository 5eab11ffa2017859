"""Batched (columns x bands) entry points."""

from .batch import fluxes_at, make_batched_problem, solve_fluxes

__all__ = ["make_batched_problem", "fluxes_at", "solve_fluxes"]
