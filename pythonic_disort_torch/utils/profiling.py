"""Observability: spans and counters inside the port, device traces, a
NaN guard.

Counterpart of ``pythonic_disort_tpu/utils/profiling.py``:

- ``span`` and ``count``: the port's named stages and counts, recorded
  only while a ``torch.profiler`` runs (any profiler: ``trace`` below,
  or ``torch.profiler.profile``).  A span is then a host event in the
  profiler's trace, on the clock of its device timeline, and its host
  time (and, given a CUDA device, its extent on the device's stream)
  adds to in-memory totals; ``recorded`` returns the totals, ``reset``
  clears them.  With no profiler running a span is a shared no-op and a
  count does nothing;
- ``trace``: ``torch.profiler`` around a block, its trace written to a
  directory (open it in Perfetto or TensorBoard);
- ``nan_guard``: raise on a NaN produced inside the block (the
  counterpart of JAX's ``jax_debug_nans``).

The spans (``device`` marks those timed on the device as well):

- ``disort.entry``, ``disort.entry.legendre``, ``disort.entry.copy``:
  `make_batched_problem`, its host table of the beam's Legendre basis,
  and each copy of a host array to the problem's device;
- ``disort.solve.assemble``, ``.eig``, ``.operands``, ``.bvp``,
  ``.outputs`` (device): the stages of the batched solve
  (``models/disort/batch_solve.py``); ``disort.solve.pole`` (device),
  between ``.eig`` and ``.operands``: the guard that moves a solve's mu0
  off the beam's resonance, with the beam's Legendre table rebuilt at the
  moved mu0 (``models/disort/solve.py::off_pole``; the single-column
  solve runs it too);
- ``disort.eval.fluxes``, ``disort.eval.modes``, ``disort.eval.nt``
  (device): the batched evaluators (``parallel/batch.py``);
  ``disort.eval.nt.series`` and ``disort.eval.nt.layers`` (device), inside
  the NT correction: its three Legendre series (the exact and truncated
  phase functions of the TMS, the IMS residual) and its cross-layer
  accumulation (``models/disort/nt.py``);
- ``disort.planck.emission``, ``disort.planck.rule``: the device Planck
  route's band integral, and the lookup of the band's cached quadrature
  rule, built on the host and copied on a miss (``ops/planck.py``);
- ``disort.grad.bvp`` (device): the backward of a block-Thomas solve, the
  fused boundary-value one's (its transposed blocks, kernel 3's transposed
  solve, the pull-back to its operands) and the generic one's
  (``ops/cuda_blocktri.py``); ``disort.grad.eig`` (device): the backward
  of the symmetric eigendecomposition (``ops/jacobi.py``);
- ``disort.build``: loading a kernel (``ops/_build.py``).  Its seconds,
  and whether nvcc ran, are recorded under ``builds`` with or without a
  profiler: a load happens once a kernel a process.

Each kernel launch (``ops/_build.py::launch``) is counted under
``launches``, by the kernel's source name (``eig_stage``,
``bvp_fused_wide``, ``blocktri``, ``blocktri_wide``, ``jacobi_eigh``,
``jacobi_eigh_wide``, ``legendre_series``, ``bvp_operands``), with or
without a profiler: ``legendre_series`` once a Legendre series on the
card, three a batched NT correction; ``bvp_operands`` once a batched solve
on the card, none where its operands take a gradient or carry a
forward-mode tangent (``ops/operands.py``).

The counters: ``h2d_bytes``, the bytes the port copies from host memory
to a CUDA device; ``host_syncs``, each point where the port blocks the
host on the device (each such pageable copy, each device value read on
the host); ``planck_rule_hits`` and ``planck_rule_builds``, the Planck
route's rule lookups served by its cache and those that built the rule;
``legendre_terms``, the Clenshaw steps of the Legendre series
(``ops/legendre.py::legendre_series_bcast``, one a moment of each series,
counted alike whether the kernel or the plain loop runs them);
``eig_stage_rows24``, the eigen-stage kernel's launches in its variant with
24-entry rows (``ops/cuda_eig.py``, 16 < n <= 24); ``beam_pole_solves``,
the solves whose mu0 the pole guard moved, summed on the device
(`count_on_device`) and read by `recorded`, so that counting adds no sync.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the gate of every span and counter: whether a profiler runs
_enabled = torch._C._autograd._profiler_enabled
# a host range of the profiler's own scope: unlike ``record_function``, the
# profiler does not mirror it on the device's timeline as an annotation
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


class _Record:
    """The totals behind `recorded`, one lock around each update."""

    def __init__(self):
        self.lock = threading.Lock()
        self.clear()

    def clear(self):
        self.spans = {}         # name -> [calls, host seconds]
        self.device_ms = {}     # name -> device ms of the resolved event pairs
        self.pending = {}       # name -> [(start event, end event)]
        self.counters = {}
        self.device_counters = {}   # name -> {device: running total, a 0-d tensor there}
        self.builds = {}
        self.launch_counts = {}


_RECORD = _Record()


class _Span:
    __slots__ = ("name", "stream", "events", "range", "t0")

    def __init__(self, name, device):
        self.name = name
        self.stream = torch.cuda.current_stream(device) if device is not None and device.type == "cuda" else None

    def __enter__(self):
        self.range = _Range(self.name)
        self.range.__enter__()
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        if self.stream is not None:
            self.events[1].record(self.stream)
        self.range.__exit__(*exc)
        r = _RECORD
        with r.lock:
            total = r.spans.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] += host
            if self.stream is not None:
                r.pending.setdefault(self.name, []).append(self.events)
        return False


def span(name: str, device: torch.device | None = None):
    """A context manager recording the stage ``name`` while a profiler
    runs: a host range in the profiler's trace, its host time in the
    totals, and on a CUDA ``device`` (the device of the stage's tensors) a
    pair of timing events on the device's current stream, whose extent
    `recorded` reads.  It never synchronizes.  With no profiler running it
    returns a shared no-op."""
    if not _enabled():
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _enabled():
        r = _RECORD
        with r.lock:
            r.counters[name] = r.counters.get(name, 0) + n


def count_on_device(name: str, flags: torch.Tensor) -> None:
    """Add the number of true entries of ``flags`` to the counter ``name``
    while a profiler runs, as a running total on their device: nothing is
    read on the host until `recorded`."""
    if _enabled():
        n = flags.detach().sum()
        r = _RECORD
        with r.lock:
            totals = r.device_counters.setdefault(name, {})
            total = totals.get(n.device)
            totals[n.device] = n if total is None else total + n


def from_host(t: torch.Tensor) -> torch.Tensor:
    """Count ``t``, just copied from host memory, if it lies on a CUDA
    device: its bytes (``h2d_bytes``) and the host sync of the pageable
    copy (``host_syncs``).  Returns ``t``."""
    if t.is_cuda and _enabled():
        count("h2d_bytes", t.nbytes)
        count("host_syncs")
    return t


def built(kernel: str, seconds: float, nvcc: bool) -> None:
    """Record a kernel's load (with or without a profiler): its seconds and
    whether nvcc compiled it."""
    r = _RECORD
    with r.lock:
        r.builds[kernel] = {"seconds": seconds, "nvcc": nvcc}


def launched(kernel: str) -> None:
    """Count one launch of ``kernel`` (with or without a profiler)."""
    r = _RECORD
    with r.lock:
        r.launch_counts[kernel] = r.launch_counts.get(kernel, 0) + 1


def recorded() -> dict:
    """The totals since the last `reset`:

    ``{"spans": {name: {"calls", "host_ms", "device_ms"}}, "counters":
    {name: n}, "builds": {kernel: {"seconds", "nvcc"}}, "launches":
    {kernel: n}}``.

    ``device_ms`` sums the device extents of a span's completed event
    pairs (None for a span never timed on a device); call it after the
    device has finished the work (``torch.cuda.synchronize()``): a pair
    still pending is left for a later call.  A counter kept on a device
    (`count_on_device`) is read here, which waits for its device.
    ``launches`` holds the kernels launched, each with its count.
    """
    r = _RECORD
    with r.lock:
        for name, pairs in r.pending.items():
            ms, left = r.device_ms.get(name, 0.0), []
            for a, b in pairs:
                if b.query():               # the end event done: the stream passed both
                    ms += a.elapsed_time(b)
                else:
                    left.append((a, b))
            r.device_ms[name] = ms
            pairs[:] = left
        spans = {name: {"calls": calls, "host_ms": 1e3 * host, "device_ms": r.device_ms.get(name)}
                 for name, (calls, host) in r.spans.items()}
        counters = dict(r.counters)
        for name, totals in r.device_counters.items():
            counters[name] = counters.get(name, 0) + sum(int(t) for t in totals.values())
        return {"spans": spans, "counters": counters,
                "builds": {k: dict(v) for k, v in r.builds.items()}, "launches": dict(r.launch_counts)}


def reset() -> None:
    """Clear the totals, the builds and the launch counts."""
    with _RECORD.lock:
        _RECORD.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host, and the card's
    kernels and copies where there is one); the trace is written to
    ``log_dir`` as ``<worker>.<time>.pt.trace.json`` when the block ends.
    The port's spans and counters are recorded inside it."""
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
