"""Device ms a chunk of the batched solve's operands between the eigen
stage and the BVP (``disort.solve.operands``: G blocks, particular
solutions, BDRF, BVP operands and right-hand side), the extent on the
device's stream (traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.solve.operands")
