"""The port's CUDA kernels: built with nvcc, loaded with ctypes, declared
and launched here.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``build/torch_kernels/<name>-<hash>.so`` under the repository
root, at first use.  The hash covers the source and the flags, so an
edited source is rebuilt.  No ``--use_fast_math``: it would turn ``/``,
``sqrtf`` and ``rsqrtf`` into approximations, and the eigen stage's
rotations and the pivoted elimination need them correctly rounded.

Every C entry point is declared once, from `SIGNATURES`, by `entry`;
`launch` calls a kernel's entry on the current stream, raises on its
error code and counts the launch (``profiling.recorded()["launches"]``,
under the source's name).  The kernel wrappers (``cuda_eig.py``,
``cuda_blocktri.py``, ``cuda_jacobi.py``, ``legendre.py``,
``operands.py``) check their operands and call `launch`.

The A/B tools (``tools/check_*.py``) build other versions of a source
(an earlier commit's, an edited copy) with the same flags and hash by
`start`, read ptxas's report of any build by `Build.ptxas`, and launch
another version on the real path, through the same wrappers, inside
`swapped`.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.

`refuse_tangents` is the check every kernel entry makes of its operands
for a forward-mode tangent, which the kernel would drop.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import forward_ad

from ..utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# ptxas reports registers, shared memory and spills per kernel; the report
# is kept beside the library as <name>-<hash>.log
REPORT_FLAGS = ["-Xptxas", "-v"]

SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of each source, {part: (argument types, return type)}:
# part p of source s is the symbol s[_p][_f32|_f64] (the launching entries,
# part "", take the stream last and return a CUDA error code).
SIGNATURES = {
    "eig_stage": {"": ([_P] * 7 + [_I] * 3 + [_P], _I), "rows": ([_I], _I)},
    "bvp_fused_wide": {"": ([_P] * 6 + [_I] * 3 + [_P], _I)},
    "blocktri": {"": ([_P] * 6 + [_I] * 3 + [_P], _I)},
    "blocktri_wide": {"": ([_P] * 7 + [_I] * 3 + [_P], _I), "workspace": ([_I] * 2, ctypes.c_size_t)},
    "jacobi_eigh": {"": ([_P] * 3 + [_I] * 3 + [_P], _I)},
    "jacobi_eigh_wide": {"": ([_P] * 4 + [_I] * 4 + [_P] * 2, _I), "workspace": ([_I] * 2, ctypes.c_size_t)},
    "legendre_series": {"": ([_P] * 3 + [_I] * 3 + [_P], _I)},
    "bvp_operands": {"": ([_P] * 10 + [_I] * 4 + [_P], _I)},
}

_loaded: dict[str, ctypes.CDLL] = {}
_swapped: dict[str, Build] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(source: bytes, stem: str) -> Path:
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def library_path(name: str) -> Path:
    """The library ``csrc/<name>.cu`` builds into under the current source
    and flags (its ptxas report beside it, ``.log``)."""
    return _target((CSRC / f"{name}.cu").read_bytes(), name)


def _start(label: str, src: Path, out: Path):
    """Start nvcc on ``src`` unless ``out`` is built; returns the job
    (label, out, the process and its temporary output, or None)."""
    if out.exists():
        return label, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *REPORT_FLAGS, "-o", str(tmp), str(src)]
    return label, out, (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)


def _finish(job) -> None:
    label, out, started = job
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {label}:\n{log.decode(errors='replace')}")
    out.with_suffix(".log").write_bytes(log)
    os.replace(tmp, out)


def _tree_job(name: str):
    return _start(f"{name}.cu", CSRC / f"{name}.cu", library_path(name))


def build(names) -> list[str]:
    """Compile the named sources, one nvcc each, all started together;
    returns the names nvcc compiled (those not built already)."""
    jobs = [_tree_job(name) for name in names]
    for job in jobs:
        _finish(job)
    return [name for name, (_, _, started) in zip(names, jobs) if started is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use; each
    load is recorded (`profiling.built`) with its seconds and whether nvcc
    ran."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("disort.build"):
            t0 = time.perf_counter()
            compiled = build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            profiling.built(name, time.perf_counter() - t0, bool(compiled))
        _loaded[name] = lib
    return lib


def kernel_sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


@functools.cache
def _declared(lib, name: str, dtype, part: str):
    """The entry point ``part`` of source ``name`` for ``dtype`` (None for
    an entry without one) in ``lib``, its signature set from `SIGNATURES`."""
    fn = getattr(lib, "_".join(s for s in (name, part, SUFFIX.get(dtype)) if s))
    fn.argtypes, fn.restype = SIGNATURES[name][part]
    return fn


def entry(name: str, dtype=None, part: str = ""):
    """The C entry point ``part`` of kernel ``name`` for ``dtype`` in the
    build the port launches: the tree's, or the one `swapped` in."""
    other = _swapped.get(name)
    return _declared(other.lib if other is not None else load(name), name, dtype, part)


def launch(name: str, dtype, device, *args) -> None:
    """Call kernel ``name``'s entry for ``dtype`` with ``args`` and the
    current stream of ``device``.  Raises ``RuntimeError`` naming the
    kernel on a nonzero return (a CUDA error code); otherwise counts one
    launch under ``name``."""
    err = entry(name, dtype)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    profiling.launched(name)


# ptxas's report of one kernel variant: the template arguments are the
# mangled part (f/d for float/double, then LiNE for each integer N)
_PTXAS = re.compile(
    r"Compiling entry function '\S*?kernelI(\w+?)EvP\S*' for.*?(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads.*?Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", re.S)


class Variant(NamedTuple):
    """What ptxas reports of one kernel variant (bytes, but registers)."""
    args: str
    registers: int
    stack: int
    spill_stores: int
    spill_loads: int
    smem: int


@dataclass(frozen=True, eq=False)
class Build:
    """A built library of kernel ``name``'s C interface: the tree's
    ``csrc/<name>.cu`` (`current`) or another version of it (`start`)."""
    label: str
    name: str
    path: Path
    lib: ctypes.CDLL

    def entry(self, dtype=None, part: str = ""):
        """`entry` in this build."""
        return _declared(self.lib, self.name, dtype, part)

    def ptxas(self) -> list[Variant]:
        """ptxas's report of the build, one `Variant` a kernel variant."""
        report = self.path.with_suffix(".log").read_text()
        return [Variant(args, int(regs), int(stack), int(st), int(ld), int(smem or 0))
                for args, stack, st, ld, regs, smem in _PTXAS.findall(report)]


def current(name: str) -> Build:
    """The build the port launches for kernel ``name``: the one `swapped`
    in, or the tree's (built and loaded on first use)."""
    return _swapped.get(name) or Build(f"{name}.cu", name, library_path(name), load(name))


def start(names=(), others=()):
    """Start nvcc, one process a source, all together: for each kernel of
    ``names`` not built yet, and for each other version of a kernel in
    ``others``, (label, kernel name, source text) with the C interface of
    ``csrc/<name>.cu``, built with the package's flags and hash from
    ``build/torch_kernels/other-<name>-<hash>.cu``.  Returns a function
    that waits for all of them and returns the other versions' builds
    (`Build`), in order."""
    jobs = {job[1]: job for job in map(_tree_job, names)}
    outs = []
    for label, name, text in others:
        out = _target(text.encode(), f"other-{name}")
        if out not in jobs:         # one nvcc a distinct text
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            out.with_suffix(".cu").write_text(text)
            jobs[out] = _start(label, out.with_suffix(".cu"), out)
        outs.append((label, name, out))

    def wait() -> list[Build]:
        for job in jobs.values():
            _finish(job)
        return [Build(label, name, out, ctypes.CDLL(str(out))) for label, name, out in outs]
    return wait


@contextlib.contextmanager
def swapped(other: Build):
    """Inside the block the port launches ``other`` in place of the tree's
    build of its kernel, through the same wrappers, checks and counts: the
    A/B tools' way to time another version on the real path."""
    before = _swapped.get(other.name)
    _swapped[other.name] = other
    try:
        yield
    finally:
        if before is None:
            del _swapped[other.name]
        else:
            _swapped[other.name] = before


def has_tangent(x) -> bool:
    """Whether ``x`` carries a forward-mode tangent (``torch.autograd.forward_ad``),
    which ``requires_grad`` does not show."""
    return forward_ad.unpack_dual(x).tangent is not None


def refuse_tangents(name: str, operands, route: str) -> None:
    """Raise ``NotImplementedError`` if an operand carries a forward-mode
    tangent: a kernel writes through ``data_ptr`` into fresh outputs, so
    the tangent would be lost.  ``route`` says where tangents go instead."""
    if any(has_tangent(x) for x in operands):
        raise NotImplementedError(f"{name}: the kernel carries no forward-mode tangent; {route}")
