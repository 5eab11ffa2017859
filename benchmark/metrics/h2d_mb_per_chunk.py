"""MB a chunk that the port copies from host memory to the device: its
``h2d_bytes`` counter (the batched entry's copies, the Planck route's and
the evaluators'; traced sub-window)."""

from yardstick import recorder


def read(ctx):
    n = recorder.counter(ctx, "h2d_bytes")
    return None if n is None else n / 1e6
