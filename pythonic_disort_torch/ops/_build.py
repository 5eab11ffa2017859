"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``build/torch_kernels/<name>-<hash>.so`` under the repository
root, at first use.  The hash covers the source and the flags, so an
edited source is rebuilt.  No ``--use_fast_math``: it would turn ``/``,
``sqrtf`` and ``rsqrtf`` into approximations, and the eigen stage's
rotations and the pivoted elimination need them correctly rounded.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.

`refuse_tangents` is the check every kernel entry makes of its operands
for a forward-mode tangent, which the kernel would drop.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns the
    process (or None) and the target path."""
    out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *REPORT_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return (proc, tmp), out


def _finish(name, started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log.decode(errors='replace')}")
    out.with_suffix(".log").write_bytes(log)
    os.replace(tmp, out)


def build(names) -> list[str]:
    """Compile the named sources, one nvcc each, all started together;
    returns the names nvcc compiled (those not built already)."""
    jobs = [(name, *_start(name)) for name in names]
    for name, started, out in jobs:
        _finish(name, started, out)
    return [name for name, started, _ in jobs if started is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use; each
    load is recorded (`profiling.built`) with its seconds and whether nvcc
    ran."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("disort.build"):
            t0 = time.perf_counter()
            compiled = build([name])
            lib = ctypes.CDLL(str(_target(name)))
            profiling.built(name, time.perf_counter() - t0, bool(compiled))
        _loaded[name] = lib
    return lib


def kernel_sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


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
