"""Device ms a chunk of the symmetric eigendecomposition's backward
(``disort.grad.eig``: the eigh rule of the eigen stage's Jacobi), the
extent on the device's stream (traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.grad.eig")
