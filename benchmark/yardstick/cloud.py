"""A Cloud C.1 deck laid into the seeded shortwave columns, frozen with the
benchmark.

DISORT's test problem 5 scatters by the Cloud C.1 phase function
(Deirmendjian's water cloud, 299 moments as tabulated by Garcia & Siewert
1985); the configuration's ``c1_moments`` hold its moments chi_l (the
Legendre coefficients over 2l + 1).  Here that cloud is a deck of
``deck["layers"]`` contiguous layers in every column of the generator's
pool, mixed per (row, layer) with the row's Henyey-Greenstein draw:

- per column, the deck's top layer, uniform over the integers of
  ``deck["top"]`` (both ends included);
- per (row, deck layer), in this order: a thickness uniform in
  ``deck["thickness"]``, an albedo uniform in ``deck["omega"]`` and a
  droplet share w uniform in ``deck["droplet_share"]``;
- moments chi_l = w C1_l + (1 - w) g^l, with g the row's drawn asymmetry of
  that layer (``leg[..., 1]`` of the generator's draws).

It draws on its own stream, ``numpy.random.default_rng([seed, 2])``, after
the generator's pool, so the pool's draws keep their order and values.
Layers outside the deck keep the pool's draws (moments g^l); the layer
bottoms ``tau`` are accumulated again from the new thicknesses, and every
layer's delta-M fraction is its moment chi_NLeg.  It imports nothing of
the port.
"""

from __future__ import annotations

import numpy as np

STREAM = 2


def add_deck(arrays, config, seed):
    """Lay the deck into the pool ``arrays`` (`generator.pool`'s, rows of
    ``config["gpoints"]`` a column), in place; returns the deck's top
    layer per column."""
    deck, rows = config["deck"], arrays["tau"].shape[0]
    c1 = np.asarray(config["c1_moments"], np.float64)
    nleg_all = arrays["leg"].shape[-1]
    if len(c1) != nleg_all:
        raise ValueError(f"c1_moments holds {len(c1)} moments, the pool {nleg_all}")
    lo, hi = deck["top"]
    if hi + deck["layers"] > config["layers"]:
        raise ValueError("the deck reaches below the column's bottom layer")
    rng = np.random.default_rng([seed, STREAM])
    columns = rows // config["gpoints"]
    top = rng.integers(lo, hi + 1, columns)
    shape = (rows, deck["layers"])
    thickness = rng.uniform(*deck["thickness"], shape)
    omega = rng.uniform(*deck["omega"], shape)
    w = rng.uniform(*deck["droplet_share"], shape)[..., None]

    r = np.arange(rows)[:, None]
    layer = np.repeat(top, config["gpoints"])[:, None] + np.arange(deck["layers"])
    g = arrays["leg"][r, layer, 1][..., None]
    arrays["leg"][r, layer] = w * c1 + (1.0 - w) * g ** np.arange(nleg_all)
    arrays["omega"][r, layer] = omega
    dtau = np.diff(arrays["tau"], axis=1, prepend=0.0)
    dtau[r, layer] = thickness
    arrays["tau"][:] = np.cumsum(dtau, axis=1)
    arrays["f_arr"] = arrays["leg"][..., config["nleg"]].copy()
    return top
