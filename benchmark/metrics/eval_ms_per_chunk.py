"""Device ms a chunk of the evaluation: the solve's outputs (probe
contraction, flux tables, GC; ``disort.solve.outputs``) and the batched
evaluators (``disort.eval.fluxes``, ``disort.eval.modes``), the summed
extents on the device's stream (traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.solve.outputs", "disort.eval.fluxes", "disort.eval.modes")
