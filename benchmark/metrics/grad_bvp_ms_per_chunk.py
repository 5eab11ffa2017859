"""Device ms a chunk of the boundary-value solve's backward
(``disort.grad.bvp``: the transposed blocks, kernel 3's transposed solve
and the pull-back of its cotangents to the solve's operands), the extent
on the device's stream (traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.grad.bvp")
