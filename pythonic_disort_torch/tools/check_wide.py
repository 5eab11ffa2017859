"""Compile-and-check call for the wide kernels on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_wide

The short first call after a change to ``csrc/jacobi_eigh_wide.cu``
(kernel 5) or ``csrc/blocktri_wide.cu`` (kernel 6): builds those two
sources and ``csrc/blocktri.cu`` (seconds), prints what ptxas reports,
holds kernel 5 to the float64 eigenvalues and to per-lane orthogonality
and reconstruction bounds at odd and wide n, and kernel 6 to its float64
plain version on random dense blocks with NaN edge blocks, in float32 and
float64, both in shared memory and in the device workspace; runs
``torch.linalg.cholesky_ex`` and ``solve_triangular`` at the batched
NQuad=68 chunk's lane count; solves ``pydisort`` at NQuad = 2, 6 and 68
in float32 against the port's float64 CPU result; times each kernel at
one shape with CUDA events.  Exits nonzero if a check fails.
`chip_smoke.py` at the repository root is the full run.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.blocktri import solve_block_tridiag_lanes
from ..ops.cuda_blocktri import launch_wide as blocktri_wide
from ..ops.cuda_jacobi import launch_wide as jacobi_wide
from ..ops.jacobi import default_sweeps
from .check_blocktri import random_blocks
from .check_jacobi import LIMITS, check_readings, cuda_ms, readings, scan_matrices


def wide_limits(n, dtype):
    """Kernel 5's limits on the readings of `check_jacobi.readings`: kernel
    4's (`check_jacobi.LIMITS`, set at n <= 32) times max(1, n / 32).  Each
    entry of V is the product of about n rotations per sweep, so the
    roundoff of a float32 Jacobi grows with n: the plain version in float32
    reconstructs the ramp matrices of `check_jacobi.scan_matrices` to about
    5e-5 at n = 128 (`chip_smoke.py` phase 3 logs its readings beside the
    kernel's)."""
    return {k: v * max(1.0, n / 32) for k, v in LIMITS[dtype].items()}


JACOBI = [(1, 5), (2, 7), (3, 33), (17, 100), (31, 9), (33, 40), (34, 65), (64, 17), (128, 3)]
BLOCKTRI = [(1, 1, 4), (3, 5, 6), (3, 66, 5), (2, 68, 3), (8, 68, 9), (2, 128, 3), (2, 136, 2), (2, 256, 2)]
BT_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}


def blocktri_rel(ops, **kw):
    x = blocktri_wide(*ops, **kw)
    torch.cuda.synchronize()
    ref = solve_block_tridiag_lanes(*(o.double().nan_to_num(0.0) for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


def main():
    if not torch.cuda.is_available():
        print("check_wide: CUDA is not available", file=sys.stderr)
        return 2
    names = ["jacobi_eigh_wide", "blocktri_wide", "blocktri"]
    t0 = time.perf_counter()
    _build.build(names)
    print(f"built {names} in {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    for name in names[:2]:
        report = _build._target(name).with_suffix(".log").read_text()
        print("\n".join(line for line in report.splitlines() if "registers" in line or "spill" in line), flush=True)
    failed = 0
    for n, B in JACOBI:
        for dtype in (torch.float32, torch.float64):
            At = scan_matrices(n, B, 10 * n + B, dtype)
            for ws in (False, True):
                w, V = jacobi_wide(At, default_sweeps(n, dtype), workspace=ws)
                label = f"jacobi_wide n={n} B={B} {str(dtype)[6:]}{' workspace' if ws else ''}"
                failed += check_readings(label, readings(At, w, V), dtype, limits=wide_limits(n, dtype))
    for L, n, B in BLOCKTRI:
        for dtype in (torch.float32, torch.float64):
            ops = random_blocks(L, n, B, 100 * L + n, dtype)
            for ws in (False, True):
                rel = blocktri_rel(ops, workspace=ws)
                ok = rel < BT_TOL[dtype]
                failed += not ok
                print(f"  blocktri_wide L={L} n={n} B={B} {str(dtype)[6:]}{' workspace' if ws else ''}: "
                      f"per-lane rel {rel:.3e} {'ok' if ok else 'FAILED'}", flush=True)

    # the library calls of the eigen-stage route at the batched NQuad=68
    # chunk's lane count (8 columns x 128 bands x 64 layers)
    for n in (34, 64):
        A = scan_matrices(n, 65536, 3, torch.float32).permute(2, 0, 1)
        try:
            Lc, info = torch.linalg.cholesky_ex(A)
            Z = torch.linalg.solve_triangular(Lc.mT, A, upper=True)
            torch.cuda.synchronize()
            err = (Lc @ Lc.mT - A).abs().max().item()
            print(f"  cholesky_ex + solve_triangular on (65536, {n}, {n}) f32: info max {int(info.max())}, "
                  f"|L L^T - A| {err:.3e}, finite {bool(torch.isfinite(Z).all())}", flush=True)
        except RuntimeError as e:
            failed += 1
            print(f"  cholesky_ex / solve_triangular on (65536, {n}, {n}) f32 FAILED: {e}", flush=True)

    from .. import pydisort
    rng = np.random.default_rng(0)
    for nquad in (2, 6, 68):
        L = 3
        kw = dict(tau_arr=np.cumsum(rng.uniform(0.1, 1.0, L)), omega_arr=rng.uniform(0.5, 0.95, L),
                  NQuad=nquad, Leg_coeffs_all=np.tile(0.7 ** np.arange(nquad + 1), (L, 1)),
                  mu0=0.6, I0=np.pi, phi0=0.3)
        tau = np.linspace(0, kw["tau_arr"][-1], 5)
        got = pydisort(**kw, dtype=torch.float32, device="cuda")
        ref = pydisort(**kw, dtype=torch.float64, device="cpu")
        for label, a, b in (("flux_up", ref[1](tau), got[1](tau)), ("u0", ref[3](tau), got[3](tau)),
                            ("u", ref[4](tau, np.array([0.0, 1.0])), got[4](tau, np.array([0.0, 1.0])))):
            d = float(np.abs(np.asarray(a) - np.asarray(b)).max())
            bound = 1e-3 * max(float(np.abs(np.asarray(a)).max()), 1.0)
            failed += not d < bound
            print(f"  pydisort NQuad={nquad} {label}: |f32 - f64| {d:.3e} (bound {bound:.3e}) "
                  f"{'ok' if d < bound else 'FAILED'}", flush=True)

    At = scan_matrices(34, 16384, 1, torch.float32)
    ms = cuda_ms(lambda: jacobi_wide(At, default_sweeps(34, torch.float32)), 5)
    print(f"  jacobi_wide n=34 B=16384 float32: {ms:.4f} ms", flush=True)
    ops = random_blocks(64, 68, 256, 1, torch.float32)
    ms = cuda_ms(lambda: blocktri_wide(*ops), 3)
    print(f"  blocktri_wide L=64 n=68 B=256 float32: {ms:.4f} ms", flush=True)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
