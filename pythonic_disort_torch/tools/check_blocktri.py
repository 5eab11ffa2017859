"""Compile-and-check call for ``csrc/blocktri.cu`` on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_blocktri

The short first call after a change to the kernel: builds that source
alone (a few seconds), prints what ptxas reports, holds the kernel to its
plain version in float64 on random dense blocks (a dominant diagonal, the
rows of every block row permuted so that the elimination exchanges rows,
NaN in the two ignored edge blocks) over small, ragged and odd shapes in
float32 and float64, and times it on such blocks at four large shapes with
CUDA events.  Exits nonzero if a check fails.  `chip_smoke.py` at the
repository root is the full run, on operands of real solves.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.blocktri import solve_block_tridiag_lanes
from ..ops.cuda_blocktri import solve_block_tridiag_lanes_cuda

CHECKED = [(3, 4, 5), (1, 8, 1), (1, 2, 3), (2, 16, 7), (6, 32, 33), (5, 48, 7), (4, 64, 9),
           (3, 33, 40), (7, 6, 100), (3, 31, 17)]
TIMED = [(64, 32, 1024), (64, 48, 1024), (64, 32, 32), (64, 64, 256)]


def random_blocks(L, n, B, seed, dtype):
    rng = np.random.default_rng(seed)
    lower, upper = (0.5 * rng.standard_normal((L, n, n, B)) / np.sqrt(n) for _ in range(2))
    diag = 3 * np.eye(n)[None, :, :, None] + rng.standard_normal((L, n, n, B)) / np.sqrt(n)
    rhs = rng.standard_normal((L, n, B))
    perm = rng.permutation(n)
    lower, diag, upper, rhs = lower[:, perm], diag[:, perm], upper[:, perm], rhs[:, perm]
    lower[0], upper[-1] = np.nan, np.nan
    return [torch.tensor(x, dtype=dtype, device="cuda").contiguous() for x in (lower, diag, upper, rhs)]


def lane_rel_err(ops):
    """Largest per-lane error of the kernel's x against the float64 plain solve."""
    x = solve_block_tridiag_lanes_cuda(*ops)
    torch.cuda.synchronize()
    ref = solve_block_tridiag_lanes(*(o.double().nan_to_num(0.0) for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


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
        print("check_blocktri: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(["blocktri"])
    print(f"built blocktri in {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    report = _build._target("blocktri").with_suffix(".log").read_text()
    print("\n".join(line for line in report.splitlines() if "registers" in line or "spill" in line), flush=True)
    failed = 0
    for L, n, B in CHECKED:
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            rel = lane_rel_err(random_blocks(L, n, B, 100 * L + n, dtype))
            failed += not rel < tol
            print(f"L={L} n={n} B={B} {dtype}: per-lane rel {rel:.3e} {'ok' if rel < tol else 'FAILED'}", flush=True)
    for L, n, B in TIMED:
        ops = random_blocks(L, n, B, 1, torch.float32)
        rel = lane_rel_err(ops)
        failed += not rel < 1e-4
        ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*ops), 5)
        print(f"L={L} n={n} B={B} float32: per-lane rel {rel:.3e}, {ms:.3f} ms", flush=True)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
