"""Carry problems and solutions between this package and numpy.

The solver has no learned weights; what crosses between the JAX package
and this one is the problem itself.  `problem_from_arrays` turns the
leaves of a JAX ``DisortProblem`` (already converted to numpy by the
caller) and its config's fields into the port's `DisortProblem`, so both
packages solve the same inputs; `solution_to_arrays` turns a solution
into numpy arrays, so the two packages' solutions compare field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.disort.types import DisortConfig, DisortProblem, DisortSolution

_LEAVES = [f.name for f in dataclasses.fields(DisortProblem) if f.name != "config"]


def problem_from_arrays(config_fields: dict, leaves: dict, device, dtype) -> DisortProblem:
    """Build the port's problem from plain config fields and numpy leaves.

    ``leaves`` maps every `DisortProblem` field name to an array (or None
    for ``lam_mu0``).
    """
    missing = [k for k in _LEAVES if k not in leaves and k != "lam_mu0"]
    if missing:
        raise KeyError(f"problem_from_arrays: missing leaves {missing}")
    tensors = {
        k: None if leaves.get(k) is None
        else torch.tensor(np.asarray(leaves[k]), dtype=dtype, device=device)
        for k in _LEAVES
    }
    return DisortProblem(config=DisortConfig(**config_fields), **tensors)


def solution_to_arrays(sol: DisortSolution) -> dict:
    """Every tensor field of a solution as a numpy array (``None`` kept)."""
    fields = {f.name: getattr(sol, f.name) for f in dataclasses.fields(sol) if f.name != "config"}
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in fields.items()}
