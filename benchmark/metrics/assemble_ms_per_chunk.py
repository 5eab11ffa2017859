"""Device ms a chunk of the batched solve's assembly, from its start to
the phase-function kernels (``disort.solve.assemble``: tables, delta-M,
source scaling, D+/D-), the extent on the device's stream (traced
sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.solve.assemble")
