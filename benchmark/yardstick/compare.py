"""The comparison that decides ``correct``: the program's outputs against
the float64 reference, row by row.

A row's error is the largest absolute difference over all its outputs,
over the largest magnitude of the reference's outputs of that row.  The
compared number is the largest row error over the sample, each row's
error first multiplied by ``min(1, d / pole)``: ``d`` is the row's
distance to a pole of its own conditioning (`reference.beam_pole_distance`:
|1 - k mu0| for the eigenvalues k of every layer and mode; with the
Nakajima-Tanaka correction also |1 - mu_i / mu0| over the streams).  Near
such a pole the problem itself magnifies rounding by about pole / d, in
any precision, so a sound float32 solve reads a fixed error there.
"""

from __future__ import annotations

import sys

import numpy as np


def row_errors(got, ref):
    """(R,) relative row errors of ``got`` against ``ref``, both (R, ...);
    a non-finite output gives an infinite error."""
    R = ref.shape[0]
    diff = np.abs(np.asarray(got, np.float64) - ref).reshape(R, -1)
    diff = np.where(np.isfinite(diff), diff, np.inf).max(axis=1)
    scale = np.abs(ref).reshape(R, -1).max(axis=1)
    return diff / np.where(scale > 0, scale, 1.0)


def conditioned(errors, distance, pole):
    """``errors`` with each row's scaled by min(1, distance / pole)."""
    return np.asarray(errors) * np.minimum(1.0, np.asarray(distance) / pole)


def nt_distance(mu, mu0):
    """(R,) min over the streams ``mu`` of |1 - mu / mu0| per row."""
    return np.abs(1.0 - np.asarray(mu)[None, :] / np.asarray(mu0)[:, None]).min(axis=1)


def reading(value, limit):
    """A compared number with its limit; NaN reads as infinite."""
    value = float(value)
    return {"value": value if np.isfinite(value) else float("inf"), "limit": float(limit)}


def passed(readings):
    return all(r["value"] <= r["limit"] for r in readings.values())


def report(name, errors, steps, rows, distance):
    """The worst compared row, and the steps whose rows read non-finite, on
    standard error."""
    k = int(np.argmax(errors))
    bad = np.unique(steps[~np.isfinite(errors)])
    print(f"{name}: {len(errors)} rows compared; worst {float(errors[k])!r} at pool row {int(rows[k])} of step "
          f"{int(steps[k])} (pole distance {float(distance[k])!r}); steps with a non-finite row: {bad[:20].tolist()} "
          f"({len(bad)})", file=sys.stderr, flush=True)
