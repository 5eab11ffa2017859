"""Compile-and-check call and A/B loop for ``csrc/blocktri.cu`` (kernel 3)
on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_blocktri [--source OTHER.cu ...]

The short loop after a change to the kernel.  It builds the tree's
``blocktri.cu`` and ``blocktri_wide.cu`` (kernel 6) and, with
``--source``, each named version of ``blocktri.cu`` (the same C
interface; an earlier commit's via ``git show
<rev>:pythonic_disort_torch/csrc/blocktri.cu > build/old_blocktri.cu``),
one nvcc each, all started together, and prints every version's ptxas
registers and spills.  While they build it captures, on the CPU in
float64 (so that no other kernel builds), the blocks of the three shapes
kernel 3 serves on the card (`captured_cases`):

- the NQuad=48 chunk's blocks, L=64, n=48, B=1024: the chunk's
  boundary-value operands (which the batched solve hands kernel 7),
  assembled as the route kernel 7 replaced assembled them for kernel 3;
- the batched gradient step's transposed blocks, L=64, n=32, B=1024: the
  bench chunk's boundary-value blocks, assembled and transposed as the
  backward of ``solve_bvp_fused`` does, with a seeded Gaussian right-hand
  side in place of the loss's cotangent;
- the 64-layer NQuad=32 column's blocks, L=64, n=32, B=32 (one lane per
  Fourier mode).

Every version is held to the float64 plain version
(``ops/blocktri.py::solve_block_tridiag_lanes``) per lane: on random dense
blocks with a dominant diagonal at the shapes of `CHECKED` and on
pivot-heavy blocks with no dominant diagonal at `PIVOT_CHECKED` (1e-4 in
float32, 1e-11 in float64), and on the captured blocks in both types (the
limits of ``chip_smoke.py``'s block-Thomas checks, 1e-3 and 1e-9).  The
tree's kernel is checked through its wrapper, the others through their C
entry.  Then every version, and kernel 6 through its C entry (the
baseline kernel 3 has to beat), is timed with CUDA events on the captured
blocks in float32 and float64, in turns (versions, then the same in
reverse order), outputs allocated once per case.  Exits nonzero if a
check fails.  ``chip_smoke.py`` at the repository root is the full run.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops.blocktri import assemble_bvp_blocks, solve_block_tridiag_lanes
from ..ops.cuda_blocktri import solve_block_tridiag_lanes_cuda, transposed_system

# (L, n, B): every variant of the kernel (n <= 16, <= 32, <= 48, <= 64) at
# ragged B, L = 1 and odd n
CHECKED = [(3, 4, 5), (1, 8, 1), (1, 2, 3), (2, 16, 7), (6, 32, 33), (5, 48, 7), (4, 64, 9),
           (3, 33, 40), (7, 6, 100), (3, 31, 17), (2, 17, 9), (4, 47, 300), (2, 24, 1025)]
PIVOT_CHECKED = [(4, 48, 300), (6, 32, 257), (3, 16, 100), (2, 64, 65), (5, 7, 33), (1, 24, 40), (3, 40, 9)]
TOL = {torch.float32: 1e-4, torch.float64: 1e-11}
REAL_TOL = {torch.float32: 1e-3, torch.float64: 1e-9}


def random_blocks(L, n, B, seed, dtype):
    """Dense blocks with a dominant diagonal, the rows of every block row
    permuted so that the elimination exchanges rows, NaN in the two ignored
    edge blocks; on the card."""
    rng = np.random.default_rng(seed)
    lower, upper = (0.5 * rng.standard_normal((L, n, n, B)) / np.sqrt(n) for _ in range(2))
    diag = 3 * np.eye(n)[None, :, :, None] + rng.standard_normal((L, n, n, B)) / np.sqrt(n)
    rhs = rng.standard_normal((L, n, B))
    perm = rng.permutation(n)
    lower, diag, upper, rhs = lower[:, perm], diag[:, perm], upper[:, perm], rhs[:, perm]
    lower[0], upper[-1] = np.nan, np.nan
    return [torch.tensor(x, dtype=dtype, device="cuda").contiguous() for x in (lower, diag, upper, rhs)]


def pivot_blocks(L, n, B, seed, dtype):
    """Blocks whose diagonal dominates nowhere: D = Q1 diag(s) Q2 with Q1,
    Q2 orthogonal (QR of Gaussian matrices) and s in [1, 2], so that every
    block is well conditioned but its largest entries lie anywhere;
    off-diagonal blocks 0.15 x Gaussian / sqrt(n) (together smaller than D
    in norm); NaN in the two ignored edge blocks."""
    rng = np.random.default_rng(seed)
    gauss = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float64, device="cuda")
    q1, q2 = (torch.linalg.qr(gauss(L * B, n, n))[0] for _ in range(2))
    s = torch.tensor(rng.uniform(1.0, 2.0, (L * B, n)), dtype=torch.float64, device="cuda")
    diag = ((q1 * s[:, None, :]) @ q2).reshape(L, B, n, n).permute(0, 2, 3, 1)
    lower, upper = (0.15 * gauss(L, n, n, B) / np.sqrt(n) for _ in range(2))
    rhs = gauss(L, n, B)
    lower[0], upper[-1] = float("nan"), float("nan")
    return [x.to(dtype).contiguous() for x in (lower, diag, upper, rhs)]


def _captured(module, name, run, pass_on=False):
    """The operands of the last call of ``module.name`` (a kernel wrapper)
    during ``run()``, cloned; the call returns zeros unless ``pass_on``."""
    wrapper, seen = getattr(module, name), []

    def record(*ops):
        seen.append(tuple(o.clone() for o in ops))
        return wrapper(*ops) if pass_on else torch.zeros_like(ops[3])
    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, wrapper)
    return seen[-1]


def captured_cases(ncols=8, nlayers=64):
    """(label, blocks in float64 on the CPU) of the three shapes kernel 3
    serves on the card (see the module docstring); ``ncols`` columns of
    128 bands for the two chunks."""
    import pythonic_disort_torch as pt
    from ..models.disort import batch_solve
    from ..ops import cuda_blocktri
    from .check_bvp import bench_arrays, bench_problem

    prob48 = bench_problem(ncols, nlayers, 48, 11)
    ops48 = _captured(batch_solve, "solve_bvp_fused", lambda: pt.solve_fluxes(prob48, prob48.tau_arr))
    chunk48 = (*assemble_bvp_blocks(*ops48[:3]), ops48[3])
    prob32 = bench_problem(ncols, nlayers, 32, 42)
    Gt, decay_t, bt_rows, rhs_t = _captured(batch_solve, "solve_bvp_fused",
                                            lambda: pt.solve_fluxes(prob32, prob32.tau_arr))
    rhs = torch.tensor(np.random.default_rng(3).standard_normal(tuple(rhs_t.shape)), dtype=torch.float64)
    transposed = (*transposed_system(*assemble_bvp_blocks(Gt, decay_t, bt_rows)), rhs)
    a = bench_arrays(1, nlayers=nlayers, nquad=32)
    column = _captured(cuda_blocktri, "solve_block_tridiag_lanes_cuda", lambda: pt.pydisort(
        tau_arr=a["tau"][0], omega_arr=a["omega"][0], NQuad=32, Leg_coeffs_all=a["leg"][0],
        mu0=float(a["mu0"][0]), I0=float(a["I0"][0]), phi0=1.0, f_arr=a["f_arr"][0],
        dtype=torch.float64, device="cpu"), pass_on=True)
    return [("NQuad=48 chunk", chunk48), ("gradient's transposed blocks", transposed),
            ("NQuad=32 column", column)]


def lane_rel(x, ops):
    """Largest per-lane error of ``x`` against the float64 plain solve of the
    same blocks (the ignored edge blocks zeroed for it), relative to the
    lane's largest |x|; inf if ``x`` is not finite."""
    torch.cuda.synchronize()
    ref = solve_block_tridiag_lanes(*(o.double().nan_to_num(0.0) for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


def lane_rel_err(ops):
    """`lane_rel` of the tree's kernel through its wrapper."""
    return lane_rel(solve_block_tridiag_lanes_cuda(*ops), ops)


def entry_call(fn, ops, wide=False, fused=False):
    """A launch of the C entry ``fn`` of a kernel-3 version (or of kernel
    6, ``wide``, or of kernel 7, ``fused``, whose entry takes kernel 3's
    arguments with the boundary-value operands (Gt, decay_t, bt_rows,
    rhs_t) in place of the blocks) on ``ops``, its outputs allocated here
    once; returns the launch function and x.  The scratch stack has
    L n (n+1) B elements in either layout ([W | g]), or L n (n/2+1) B
    with ``fused`` ([H | g], n = 2N)."""
    L, n, _, B = ops[0].shape
    WG = torch.empty(B * L * n * (n // 2 + 1 if fused else n + 1), dtype=ops[0].dtype, device="cuda")
    x = torch.empty_like(ops[3])
    ptrs = [t.data_ptr() for t in (*ops, WG, x)]
    stream = torch.cuda.current_stream().cuda_stream
    if wide:
        return (lambda: fn(*ptrs, None, L, n, B, stream)), x
    return (lambda: fn(*ptrs, L, n, B, stream)), x


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


def time_versions(versions, cases, reps=5, fused=False):
    """Each `_build.Build` of ``versions`` (a kernel-3 version, or kernel 6,
    or kernel 7 with ``fused``) on the operands of each case (label, ops),
    through its C entry, in turns: versions, then the same in reverse
    order."""
    for label, ops in cases:
        L, n, _, B = ops[0].shape
        dtype = ops[0].dtype
        times = {}
        for version in versions + versions[::-1]:
            call, _ = entry_call(version.entry(dtype), ops, version.name == "blocktri_wide", fused)
            if call():
                raise RuntimeError(f"{version.label}: launch failed at L={L} n={n} B={B}")
            times.setdefault(version.label, []).append(cuda_ms(call, reps))
        print(f"time {label} L={L} n={n} B={B} {str(dtype)[6:]} (C entry, ms):", flush=True)
        for name, ts in times.items():
            print(f"    {' '.join(f'{t:.4f}' for t in ts)}  {name}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build, check and time kernel 3 (and other versions) on one GPU.")
    parser.add_argument("--source", nargs="*", default=[], help="other versions of blocktri.cu to check and time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_blocktri: CUDA is not available", file=sys.stderr)
        return 2
    from .check_wide import print_ptxas

    t0 = time.perf_counter()
    names = ["blocktri", "blocktri_wide"]
    pending = _build.start(names, [(path, "blocktri", Path(path).read_text()) for path in args.source])
    cases = captured_cases()
    print(f"captured {len(cases)} sets of blocks on the CPU in float64 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    built = pending()
    print(f"built {names} and {len(built)} other versions in {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"{smi.stdout.strip() or 'nvidia-smi failed'}; torch {torch.__version__}", flush=True)
    for version in [*map(_build.current, names), *built]:
        print_ptxas(version.label, version.ptxas())

    failed = 0

    def held(label, rel, tol):
        nonlocal failed
        ok = rel < tol
        failed += not ok
        print(f"  {label}: per-lane rel {rel:.3e} {'ok' if ok else 'FAILED'} (limit {tol:g})", flush=True)

    def check_all(what, ops, tol):
        held(f"blocktri.cu {what}", lane_rel_err(ops), tol)
        for version in built:
            call, x = entry_call(version.entry(ops[1].dtype), ops)
            held(f"{version.label} {what}", float("inf") if call() else lane_rel(x, ops), tol)

    for dtype in (torch.float32, torch.float64):
        dt = str(dtype)[6:]
        for L, n, B in CHECKED:
            check_all(f"L={L} n={n} B={B} {dt} (dominant diagonal, rows permuted)",
                      random_blocks(L, n, B, 100 * L + n, dtype), TOL[dtype])
        for L, n, B in PIVOT_CHECKED:
            check_all(f"L={L} n={n} B={B} {dt} (no dominant diagonal)", pivot_blocks(L, n, B, 7 * n + L, dtype),
                      TOL[dtype])
    timed = []
    for dtype in (torch.float32, torch.float64):
        for label, ops in cases:
            ops = tuple(o.to("cuda", dtype).contiguous() for o in ops)
            L, n, _, B = ops[1].shape
            check_all(f"{label} L={L} n={n} B={B} {str(dtype)[6:]}", ops, REAL_TOL[dtype])
            timed.append((label, ops))
    wide = _build.current("blocktri_wide")
    for label, ops in timed:
        call, x = entry_call(wide.entry(ops[1].dtype), ops, wide=True)
        L, n, _, B = ops[1].shape
        held(f"blocktri_wide.cu (kernel 6) {label} L={L} n={n} B={B} {str(ops[1].dtype)[6:]}",
             float("inf") if call() else lane_rel(x, ops), REAL_TOL[ops[1].dtype])
    time_versions([_build.current("blocktri"), *built, wide], timed)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
