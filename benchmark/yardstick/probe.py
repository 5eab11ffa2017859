"""Spans and host clocks the drivers put around their calls into the port.

In the measured window a span only reads the host clock.  In the traced
sub-window it is also a ``torch.profiler.record_function`` span named
``bench.<name>``, and a span opened with ``sync=True`` synchronizes the
device before and after, so that its clock covers the device work it
launched.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Probe:
    def __init__(self, synchronize):
        self.synchronize = synchronize
        self.tracing = False
        self.clocks = defaultdict(list)     # (phase, span) -> seconds

    @property
    def phase(self):
        return "trace" if self.tracing else "window"

    @contextlib.contextmanager
    def span(self, name, sync=False):
        record = contextlib.nullcontext()
        if self.tracing:
            from torch.profiler import record_function

            record = record_function("bench." + name)
        with record:
            if sync and self.tracing:
                self.synchronize()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync and self.tracing:
                    self.synchronize()
                self.clocks[(self.phase, name)].append(time.perf_counter() - t0)
