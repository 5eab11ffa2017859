"""Seconds the run's process spent loading the port's CUDA kernels, nvcc
included where a kernel was not built yet (``disort.build``; set-up
included)."""

from yardstick import recorder


def read(ctx):
    return recorder.build_seconds()
