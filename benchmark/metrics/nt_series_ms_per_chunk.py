"""Device ms a chunk of the Nakajima-Tanaka corrections' Legendre series
(``disort.eval.nt.series``: the exact and truncated phase functions of the
TMS and the IMS residual series), the extent on the device's stream
(traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.eval.nt.series")
