"""Compile-and-check call for ``csrc/jacobi_eigh.cu`` on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_jacobi

The short first call after a change to the kernel: builds that source
alone (a few seconds), prints what ptxas reports, holds the kernel to the
float64 eigenvalues of the same matrices and to per-lane orthogonality
and reconstruction bounds, over small, ragged and odd-width shapes in
float32 and float64, on batches whose diagonals tie exactly, in pairs or
all alike (a tied pair turns by 45 degrees), and on the 131072-lane
reconstruction scan of the TPU kernel's regression test; then times it at
n = 16, B = 65536 with CUDA events.  Exits nonzero if a check fails.
`chip_smoke.py` at the repository root is the full run, on operands of
real solves.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.cuda_jacobi import jacobi_eigh_lanes
from ..ops.jacobi import default_sweeps

CHECKED = [(2, 7), (4, 33), (8, 100), (10, 17), (16, 1), (16, 1000), (24, 300), (30, 40), (32, 65)]
# per-reading limits: sorted w against float64 (relative to the lane's
# largest |w|), per-lane max |V^T V - I|, per-lane max |V diag(w) V^T - A|
# relative to the lane's largest |A|
LIMITS = {torch.float32: dict(w=3e-5, orth=1e-4, recon=3e-5),
          torch.float64: dict(w=1e-12, orth=1e-12, recon=1e-12)}
# A dense matrix without a dominant diagonal (`constant_diagonal_matrices`)
# needs one sweep more than `default_sweeps` in float32 at n >= 16 to
# reconstruct within LIMITS, the plain version as well; the eigen stage's
# operands converge in 4.  At the default count such a batch is held on
# sorted w and orthogonality (`DEFAULT_SWEEP_READINGS`), and on every
# reading one sweep later.
DEFAULT_SWEEP_READINGS = ("w", "orth")
EIGH_CHUNK = 16384     # cuSOLVER's batched eigh refuses 32768 or more matrices


def lanes(A, dtype):
    """(B, n, n) numpy -> (n, n, B) contiguous CUDA tensor."""
    return torch.tensor(np.moveaxis(A, 0, -1), dtype=dtype, device="cuda").contiguous()


def scan_matrices(n, B, seed, dtype):
    """The TPU kernel's regression scan: symmetric noise of scale 0.1 on a
    diagonal ramp from 1 to 4 (tests_tpu/test_tpu_production.py)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    return lanes((base + np.swapaxes(base, -1, -2)) / 2 + np.eye(n) * np.linspace(1, 4, n), dtype)


def tied_matrices(n, B, seed, dtype):
    """Symmetric matrices whose diagonal holds each of n/2 values twice, in
    a random order per lane: the pairs that meet with equal carried
    diagonals have theta == 0 exactly."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    A = (base + np.swapaxes(base, -1, -2)) / 2
    idx = np.arange(n)
    A[:, idx, idx] = rng.permuted(np.broadcast_to(np.repeat(np.linspace(1, 4, n // 2), 2), (B, n)), axis=1)
    return lanes(A, dtype)


def constant_diagonal_matrices(n, B, seed, dtype):
    """Symmetric matrices whose diagonal entries are all 2: every pair of
    every round of the first sweep is tied (n = 2: [[2, a], [a, 2]])."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.3
    A = (base + np.swapaxes(base, -1, -2)) / 2
    idx = np.arange(n)
    A[:, idx, idx] = 2.0
    return lanes(A, dtype)


def eigvalsh64(At):
    """Ascending float64 eigenvalues (B, n) of lanes ``At``, in chunks."""
    A = At.double().permute(2, 0, 1)
    return torch.cat([torch.linalg.eigvalsh(A[b:b + EIGH_CHUNK]) for b in range(0, A.shape[0], EIGH_CHUNK)])


def readings(At, w, V, w64=None):
    """Order-free readings of ``w`` (n, B), ``V`` (n, n, B) for ``At``: sorted
    w against the ascending float64 eigenvalues ``w64`` (B, n) (relative and
    absolute), per-lane orthogonality, per-lane reconstruction (relative
    and absolute), each the largest over the lanes, and the per-lane
    absolute reconstruction errors."""
    A = At.double().permute(2, 0, 1)
    w, V = w.double().T, V.double().permute(2, 0, 1)
    w64 = eigvalsh64(At) if w64 is None else w64
    scale = A.abs().amax(dim=(1, 2))
    eye = torch.eye(A.shape[1], dtype=torch.float64, device=A.device)
    recon = (V @ (w[:, :, None] * V.mT) - A).abs().amax(dim=(1, 2))
    w_err = (w.sort(dim=1).values - w64).abs().amax(dim=1)
    return dict(
        w=(w_err / w64.abs().amax(dim=1)).max().item(),
        w_abs=w_err.max().item(),
        orth=(V.mT @ V - eye).abs().amax(dim=(1, 2)).max().item(),
        recon=(recon / scale).max().item(),
        recon_abs=recon.max().item(),
        lanes_abs=recon,
    )


def check_readings(label, r, dtype, log=print, keys=None, limits=None):
    """Log the readings and hold them (``keys``, default all) to ``limits``
    (default `LIMITS`); returns the failed count."""
    lim = limits or LIMITS[dtype]
    bad = [k for k in (keys or lim) if not r[k] < lim[k]]
    log(f"  {label}: sorted w rel {r['w']:.3e}, per-lane |V^T V - I| {r['orth']:.3e}, "
        f"|V diag(w) V^T - A| rel {r['recon']:.3e} (abs {r['recon_abs']:.3e}) "
        + ("ok" if not bad else f"FAILED {bad}"))
    return len(bad)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    if not torch.cuda.is_available():
        print("check_jacobi: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(["jacobi_eigh"])
    print(f"built jacobi_eigh in {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    report = _build._target("jacobi_eigh").with_suffix(".log").read_text()
    print("\n".join(line for line in report.splitlines() if "registers" in line or "spill" in line), flush=True)
    eig = lambda At, more=0: jacobi_eigh_lanes(At, default_sweeps(At.shape[0], At.dtype) + more)
    failed = 0
    for n, B in CHECKED:
        for dtype in (torch.float32, torch.float64):
            for what, make in (("ramp", scan_matrices), ("tied pairs", tied_matrices),
                               ("constant diagonal", constant_diagonal_matrices)):
                At = make(n, B, 10 * n + B, dtype)
                label = f"n={n} B={B} {str(dtype)[6:]} {what}"
                dense = make is constant_diagonal_matrices
                w, V = eig(At)
                failed += check_readings(label, readings(At, w, V), dtype,
                                         keys=DEFAULT_SWEEP_READINGS if dense else None)
                if dense:
                    w, V = eig(At, 1)
                    failed += check_readings(f"{label}, one sweep more", readings(At, w, V), dtype)
    At = scan_matrices(16, 131072, 0, torch.float32)
    w, V = eig(At)
    r = readings(At, w, V)
    n_bad = int((r["lanes_abs"] > 1e-3).sum())
    ok = n_bad == 0 and r["recon_abs"] < 1e-4
    failed += not ok
    print(f"  scan n=16 B=131072 float32: {n_bad} lanes above 1e-3, max {r['recon_abs']:.3e} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    At = scan_matrices(16, 65536, 1, torch.float32)
    ms = cuda_ms(lambda: eig(At), 20)
    print(f"  n=16 B=65536 float32: {ms:.4f} ms", flush=True)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
