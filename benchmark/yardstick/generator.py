"""Seeded inputs of the cells, frozen with the benchmark.

The optical draws keep the order and ranges of the repository's original
sweep generator (``bench.py:51-77``; the port carries it as
``tools/check_bvp.py::bench_arrays``): per row, layer thicknesses,
single-scattering albedos and Henyey-Greenstein asymmetries, then the
beam's mu0.  Every row is drawn independently; a "column" is a run of
``gpoints`` consecutive rows.  The ranges come from the configuration's
``draws``, so every seed gives the same sizes and only the values differ.
"""

from __future__ import annotations

import numpy as np


def optics(rng, rows, layers, nleg_all, draws):
    """Host float64 arrays of ``rows`` rows: ``tau`` (rows, layers), the
    cumulative layer bottoms; ``omega``; ``leg`` (rows, layers, nleg_all),
    g^l; ``f_arr``, the delta-M fraction g^(nleg_all - 1); ``mu0``,
    ``I0`` and ``phi0`` (rows,)."""
    thickness = rng.uniform(*draws["thickness"], (rows, layers))
    omega = rng.uniform(*draws["omega"], (rows, layers))
    g = rng.uniform(*draws["g"], (rows, layers))
    leg = g[..., None] ** np.arange(nleg_all)
    mu0 = rng.uniform(*draws["mu0"], rows)
    phi0 = rng.uniform(*draws["phi0"], rows)
    return dict(tau=np.cumsum(thickness, axis=1), omega=omega, leg=leg, f_arr=leg[..., nleg_all - 1].copy(),
                mu0=mu0, I0=np.full(rows, float(draws["I0"])), phi0=phi0)


def temperatures(rng, columns, levels, draws):
    """(columns, levels) profiles, top to bottom: linear in the level index
    from a top temperature to a surface one, each drawn per column, with
    uniform noise at every level."""
    top = rng.uniform(*draws["top"], (columns, 1))
    surface = rng.uniform(*draws["surface"], (columns, 1))
    frac = np.linspace(0.0, 1.0, levels)[None, :]
    return top + (surface - top) * frac + rng.uniform(-draws["noise"], draws["noise"], (columns, levels))


def planck_fractions(rng, bands, per_band, draws):
    """(bands, per_band) positive fractions of each band's Planck emission
    given to its g-points, each band's summing to 1."""
    w = rng.uniform(*draws["planck_fraction"], (bands, per_band))
    return w / w.sum(axis=1, keepdims=True)


def pool(config, seed):
    """The cell's inputs from ``seed``: ``config["columns"]`` columns of
    ``config["gpoints"]`` rows each, and for thermal sources the columns'
    temperature profiles and the g-points' Planck fractions."""
    rng = np.random.default_rng(seed)
    rows = config["columns"] * config["gpoints"]
    out = optics(rng, rows, config["layers"], config["nleg_all"], config["draws"])
    if config["sources"] == "thermal":
        out["temper"] = temperatures(rng, config["columns"], config["layers"] + 1, config["draws"])
        out["fractions"] = planck_fractions(rng, len(config["band_edges"]) - 1, config["gpoints_per_band"],
                                            config["draws"])
    return out


def sample_rng(seed, stream):
    """A generator for the cell's samples, independent of its inputs."""
    return np.random.default_rng([seed, stream])
