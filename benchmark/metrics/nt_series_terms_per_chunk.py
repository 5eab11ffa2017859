"""Clenshaw steps a chunk of the port's Legendre series (its
``legendre_terms`` counter, one step a moment of each series summed;
traced sub-window): a witness of the series' length, 300 + 48 + 300 at
NLeg = 48 with 300 moments.  None where nothing was counted (a port
without the counter)."""

from yardstick import recorder


def read(ctx):
    return recorder.counter(ctx, "legendre_terms") or None
