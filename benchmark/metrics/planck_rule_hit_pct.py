"""Share of the Planck route's band-rule lookups that its cache served, in
%: ``planck_rule_hits`` / (``planck_rule_hits`` + ``planck_rule_builds``)
(traced sub-window); None where neither counter counted, as in a port
without the cache."""

from yardstick import recorder


def read(ctx):
    hits, builds = recorder.counter(ctx, "planck_rule_hits"), recorder.counter(ctx, "planck_rule_builds")
    if not hits and not builds:
        return None
    return 100.0 * hits / (hits + builds)
