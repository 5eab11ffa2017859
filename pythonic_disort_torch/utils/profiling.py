"""Observability: wall-clock stage timing, device traces, a NaN guard.

Counterpart of ``pythonic_disort_tpu/utils/profiling.py``:

- ``device_sync`` and ``StageTimer``: structured wall-clock timing of
  named stages, synchronized with the device of a result;
- ``trace``: ``torch.profiler`` around a block, its trace written to a
  directory (open it in Perfetto or TensorBoard);
- ``nan_guard``: raise on a NaN produced inside the block (the
  counterpart of JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def device_sync(x):
    """Wait for the device of the first tensor in ``x`` (any nesting of
    tuples, lists, dicts and named tuples) to finish its work; return ``x``."""
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            break
    return x


class StageTimer:
    """Accumulate named stage timings; render as a JSON line."""

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self):
        return json.dumps({k: round(v, 6) for k, v in self.stages.items()})


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host, and the card's
    kernels and copies where there is one); the trace is written to
    ``log_dir`` as ``<worker>.<time>.pt.trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise ``FloatingPointError`` on a NaN in the floating output of any
    aten operation inside the block (a debug sanitizer).

    It sees aten operations only: the output of a CUDA kernel launched
    through its wrapper is caught at the first aten operation that reads
    it.  Every check reads its result on the host, which synchronizes the
    stream at every operation: keep it out of timed code.
    """
    with _NanGuard():
        yield
