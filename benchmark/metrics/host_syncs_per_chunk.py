"""Points a chunk where the port blocks the host on the device: its
``host_syncs`` counter (each pageable host-to-device copy, each device
value read on the host; traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.counter(ctx, "host_syncs")
