"""Device ms a chunk of the Nakajima-Tanaka corrections
(``disort.eval.nt``), the extent on the device's stream (traced
sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.eval.nt")
