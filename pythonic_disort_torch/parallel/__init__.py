"""Parallel execution: batched solves, meshes of ranks, sweep driver."""

from .mesh import (
    BATCH_AXIS,
    batch_sharding,
    count_collectives,
    default_mesh,
    initialize_distributed,
    make_mesh,
    shard_batch,
)
from .batch import (
    actinic_at, fluxes_at, global_flux_stats, make_batched_problem, solve_actinic, solve_batch, solve_fluxes,
    solve_fluxes_sharded, solve_intensity, solve_intensity_sharded, u0_at, u_at, u_corrected_at,
)
from .sweep import SweepDriver

__all__ = [
    "BATCH_AXIS", "batch_sharding", "default_mesh", "make_mesh",
    "initialize_distributed", "shard_batch", "count_collectives", "fluxes_at",
    "global_flux_stats", "make_batched_problem", "solve_batch",
    "solve_fluxes", "solve_fluxes_sharded", "solve_intensity",
    "solve_intensity_sharded",
    "solve_actinic", "u0_at", "u_at", "u_corrected_at", "actinic_at",
    "SweepDriver",
]
