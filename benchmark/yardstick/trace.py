"""Reduction of a ``torch.profiler`` trace of the traced sub-window.

The device's busy time is the union of its kernel, copy and set intervals
inside the window; the window is the benchmark's own ``bench.window``
span.  Idle gaps are labelled by what the host's main thread was doing
at their middle: the innermost benchmark span and the innermost host
operation open there.
"""

from __future__ import annotations

import re
from collections import Counter

WINDOW = "bench.window"
# CUDA runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
              "cudaMemcpy2D", "cudaMemset")
_HEAD = re.compile(r"^(?:void\s+)?([^<(]*)")


def base_name(name):
    """A device kernel's name without ``void``, namespaces, template and
    arguments: ``void (anonymous namespace)::eig_stage_kernel<float, 16,
    8>(...)`` -> ``eig_stage_kernel``."""
    head = _HEAD.match(name.replace("(anonymous namespace)::", "")).group(1)
    return head.rsplit("::", 1)[-1].strip()


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


class Trace:
    """Device intervals, host spans and host runtime calls of one window."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        win = [e for e in events if e.name == WINDOW]
        if not win:
            raise ValueError("the trace holds no bench.window span")
        w = win[0]
        self.thread = w.thread
        self.start, self.end = w.time_range.start, w.time_range.end
        self.window_s = (self.end - self.start) * 1e-6
        dev, host = [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # the profiler mirrors each benchmark span on the device's
                # timeline as an annotation; it is not device work
                if b > self.start and not e.name.startswith("bench.") and a < self.end:
                    dev.append((max(a, self.start), min(b, self.end), e.name))
            elif e.thread == self.thread and self.start <= a <= self.end:
                host.append((a, b, e.name))
        self.device = sorted(dev)
        self.host = sorted(host, key=lambda x: (x[0], -x[1]))
        self.merged = []
        for a, b, _ in self.device:
            if self.merged and a <= self.merged[-1][1]:
                self.merged[-1][1] = max(self.merged[-1][1], b)
            else:
                self.merged.append([a, b])
        self.busy_s = sum(b - a for a, b in self.merged) * 1e-6

    def seconds_by_name(self):
        """Device seconds by operation name."""
        out = Counter()
        for a, b, name in self.device:
            out[name] += (b - a) * 1e-6
        return out

    def kernel_count(self):
        return sum(1 for _, _, name in self.device if is_kernel(name))

    def stage_seconds(self, kernels):
        """Device seconds of the kernels whose base name is in ``kernels``;
        None if none ran."""
        hits = [(b - a) for a, b, name in self.device if is_kernel(name) and base_name(name) in kernels]
        return sum(hits) * 1e-6 if hits else None

    def spans(self, name):
        """(start, end) of the host spans named ``name``."""
        return [(a, b) for a, b, n in self.host if n == name]

    def calls_within(self, names, span):
        """Host calls named in ``names`` that start inside a span ``span``."""
        spans = self.spans(span)
        return sum(1 for a, _, n in self.host if n in names and any(s <= a <= e for s, e in spans))

    def gaps(self):
        """(start, end) of the device's idle intervals inside the window."""
        out, t = [], self.start
        for a, b in self.merged:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def idle_by_host(self, top=10):
        """Idle seconds by what the host was doing, the ``top`` largest:
        ``[["<benchmark span>/<host operation>", seconds], ...]``; "python"
        where no traced operation was open (Python or NumPy code)."""
        gaps = sorted(self.gaps(), key=lambda g: 0.5 * (g[0] + g[1]))
        totals = Counter()
        stack, i = [], 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(self.host) and self.host[i][0] <= mid:
                stack.append(self.host[i])
                i += 1
            stack = [h for h in stack if h[1] >= mid]
            span = next((h[2] for h in reversed(stack) if h[2].startswith("bench.") and h[2] != WINDOW), "-")
            op = next((h[2] for h in reversed(stack) if not h[2].startswith("bench.")), "python")
            totals[f"{span}/{op}"] += (b - a) * 1e-6
        return [[k, v] for k, v in totals.most_common(top)]

    def top_device_ops(self, top=10):
        return [[k, v] for k, v in self.seconds_by_name().most_common(top)]
