"""Compile-and-check call for the fused boundary-value kernels on one NVIDIA
GPU: ``csrc/bvp_fused.cu`` (kernel 2, 2N <= 32) and
``csrc/bvp_fused_wide.cu`` (kernel 7, 34 <= 2N <= 64).

    python3 -m pythonic_disort_torch.tools.check_bvp [--source OTHER.cu ...]

The short loop after a change to either kernel, and kernel 7's A/B loop: builds ``bvp_fused``,
``bvp_fused_wide`` and ``blocktri`` alone (one nvcc each, started
together), prints what ptxas reports for every variant in float32 and
float64 (a variant that spills fails the check), and holds each kernel to
the float64 plain version, per lane, at the limits of ``chip_smoke.py``'s
``bvp_checks`` (1e-3 in float32, 1e-9 in float64):

- on the operands of real solves, captured from ``solve_fluxes`` on
  problems of ``bench.py``'s generator built by ``make_batched_problem``
  (float64 on the CPU up to the BVP, so no other kernel is built):
  kernel 2 at the main-path shape (L = 64, 2N = 32, B = 1024) in float32
  and float64, 2N = 2, 6 and 30, L = 1 and L = 5 at ragged B (777, 1001);
  kernel 7 at the NQuad=48 chunk's shape (L = 64, 2N = 48, B = 1024) in
  float32 and float64, 2N = 34, 48 and 64, L = 1 and L = 5 at ragged B;
- on random operands with a dense G whose diagonal is not dominant, so
  that partial pivoting picks rows off the diagonal, at 2N up to 64.

Then it times, with CUDA events in float32: at L = 64, 2N = 32, B = 1024
on the main-path operands, kernel 2; the route it replaces,
``assemble_bvp_blocks`` + kernel 3; and kernel 3 alone on the assembled
blocks; and the same three with kernel 7 at the NQuad=48 chunk's
operands (L = 64, 2N = 48, B = 1024).  With ``--source``, each named
version of ``bvp_fused_wide.cu`` (the same C interface: an earlier
commit's via ``git show <rev>:pythonic_disort_torch/csrc/bvp_fused_wide.cu
> build/old_bvp_wide.cu``, or an edited copy that skips a stage) is built
beside the tree's, its ptxas report printed, its per-lane error on the
NQuad=48 chunk's operands printed (not counted: a copy that skips a stage
is wrong by design), and all versions, the tree's first, are timed in
turns through their C entries there, in float32 and float64.  Exits
nonzero if a check of the tree's kernels fails.  ``chip_smoke.py`` at the
repository root is the full run.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.blocktri import assemble_bvp_blocks
from ..ops.cuda_blocktri import (
    FUSED_NARROW_MAX, solve_block_tridiag_lanes_cuda, solve_bvp_fused, solve_bvp_fused_plain)
from .check_blocktri import cuda_ms, entry_call, time_versions

def spill_bytes(name):
    """Bytes spilled (stores plus loads) over every variant of ``name``."""
    return sum(v.spill_stores + v.spill_loads for v in _build.current(name).ptxas())


def bench_arrays(ncols, seed=42, nlayers=64, nquad=32, nbands=128):
    """The generator of bench.py:51-77 (same seed, same draws)."""
    rng = np.random.default_rng(seed)
    B = ncols * nbands
    thickness = rng.uniform(0.05, 0.5, (B, nlayers))
    omega = rng.uniform(0.3, 0.99, (B, nlayers))
    g = rng.uniform(0.5, 0.85, (B, nlayers))
    leg = g[..., None] ** np.arange(nquad + 1)[None, None, :]
    return dict(tau=np.cumsum(thickness, axis=1), omega=omega, leg=leg, f_arr=leg[..., nquad],
                mu0=rng.uniform(0.2, 1.0, B), I0=np.full(B, np.pi))


def batched_problem(a, nquad, dtype, device):
    """The flux-only delta-M beam problem of the arrays ``a`` (the keys of
    `bench_arrays`; ``a["omega"]`` may be a tensor, which the problem keeps
    as its own), built by ``make_batched_problem`` at NQuad = nquad."""
    import pythonic_disort_torch as pt

    cfg = pt.DisortConfig(
        nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=1, nlayers=a["tau"].shape[1],
        nscoeffs=0, nbdrf=0, has_beam=True, only_flux=True, has_deltam=True)
    return pt.make_batched_problem(cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"],
                                   f_arr=a["f_arr"], dtype=dtype, device=device)


def bench_problem(ncols, nlayers, nquad, seed):
    """`batched_problem` of `bench_arrays` in float64 on the CPU."""
    return batched_problem(bench_arrays(ncols, seed=seed, nlayers=nlayers, nquad=nquad), nquad, torch.float64, "cpu")


@functools.lru_cache(maxsize=None)
def _captured_f64(ncols, nlayers, nquad, seed):
    import pythonic_disort_torch as pt
    from ..models.disort import batch_solve

    prob = bench_problem(ncols, nlayers, nquad, seed)
    seen = []

    def record(*ops):
        seen.append(tuple(o.clone() for o in ops))
        return torch.zeros_like(ops[3])   # the fluxes are not wanted

    batch_solve.solve_bvp_fused = record
    try:
        pt.solve_fluxes(prob, prob.tau_arr)
    finally:
        batch_solve.solve_bvp_fused = solve_bvp_fused
    return seen[-1]


# (ncols, nlayers, nquad, seed) of the captured solves main() checks
CAPTURED = [(8, 64, 32, 42), (8, 64, 48, 11), *((1, 16, q, q) for q in (2, 6, 30, 34, 48, 64)),
            (7, 1, 32, 6), (7, 1, 48, 6), (8, 5, 32, 7), (8, 5, 64, 7)]


def captured_operands(ncols, nlayers, nquad, seed, dtype):
    """The operands ``solve_fluxes`` hands the fused solve on a
    `bench_problem` (2N = nquad <= 64), solved up to the BVP in float64 on
    the CPU once (no other kernel is built), as ``dtype`` on the card."""
    return tuple(o.to("cuda", dtype).contiguous() for o in _captured_f64(ncols, nlayers, nquad, seed))


def random_operands(L, N, B, seed, dtype):
    """Operands of ``tests/test_torch_blocktri.py::_operands``'s kind
    (G = I + a dense random part, decays in (0.05, 0.95), boundary rows
    I + noise, Gaussian right-hand sides) with G's columns rolled by one
    within each half: no diagonal entry of G is large, and the pivots of
    the elimination lie off the diagonal."""
    rng = np.random.default_rng(seed)
    n2 = 2 * N
    G = np.eye(n2)[None, :, :, None] + 0.3 * rng.standard_normal((L, n2, n2, B)) / np.sqrt(n2)
    G = G[:, :, np.concatenate([np.roll(np.arange(N), 1), N + np.roll(np.arange(N), 1)])]
    decay = rng.uniform(0.05, 0.95, (L, N, B))
    bt_rows = np.concatenate(
        [np.eye(N)[:, :, None] + 0.2 * rng.standard_normal((N, N, B)), 0.2 * rng.standard_normal((N, N, B))], axis=1)
    rhs = rng.standard_normal((L, n2, B))
    return tuple(torch.tensor(x, dtype=dtype, device="cuda").contiguous() for x in (G, decay, bt_rows, rhs))


def lane_rel(x, ops):
    """Largest per-lane error of ``x`` against the float64 plain solve of
    ``ops``, relative to the lane's largest |x| there; inf if ``x`` is not
    finite."""
    torch.cuda.synchronize()
    ref = solve_bvp_fused_plain(*(o.double() for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


def lane_rel_err(ops):
    """`lane_rel` of the fused solve (kernel 2 or 7, by 2N) through its
    wrapper."""
    return lane_rel(solve_bvp_fused(*ops), ops)


def timed_routes(ops, label):
    """CUDA-event ms of the fused solve, of the route it replaces
    (``assemble_bvp_blocks`` + kernel 3) and of kernel 3 alone on the
    assembled blocks, on ``ops``; printed under ``label``."""
    blocks = assemble_bvp_blocks(*ops[:3])
    fused_ms = cuda_ms(lambda: solve_bvp_fused(*ops), 20)
    route_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(*ops[:3]), ops[3]), 20)
    k3_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*blocks, ops[3]), 20)
    kernel = "bvp_fused_wide" if ops[0].shape[1] > FUSED_NARROW_MAX else "bvp_fused"
    print(f"{label}: {kernel} {fused_ms:.4f} ms; assemble_bvp_blocks + blocktri {route_ms:.4f} ms; "
          f"blocktri alone {k3_ms:.4f} ms", flush=True)
    return fused_ms, route_ms, k3_ms


def ab_versions(built, cases):
    """The tree's kernel 7 and the ``--source`` versions on each case
    (label, ops): per-lane error through their C entries (printed), then
    `check_blocktri.time_versions` in turns."""
    versions = [_build.current("bvp_fused_wide"), *built]
    for label, ops in cases:
        for version in versions:
            call, x = entry_call(version.entry(ops[0].dtype), ops, fused=True)
            rel = float("inf") if call() else lane_rel(x, ops)
            print(f"  {version.label} {label} {str(ops[0].dtype)[6:]}: per-lane rel {rel:.3e}", flush=True)
    time_versions(versions, cases, fused=True)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", nargs="*", default=[], help="other versions of bvp_fused_wide.cu to time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_bvp: CUDA is not available", file=sys.stderr)
        return 2
    from pathlib import Path

    from .check_wide import print_ptxas

    names = ("bvp_fused", "bvp_fused_wide", "blocktri")
    t0 = time.perf_counter()
    pending = _build.start(names, [(path, "bvp_fused_wide", Path(path).read_text()) for path in args.source])
    # the real solves' operands, captured on the CPU while nvcc runs
    for args in CAPTURED:
        _captured_f64(*args)
    print(f"captured {len(CAPTURED)} sets of operands on the CPU in float64 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    built = pending()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"built {', '.join(names)} in {time.perf_counter() - t0:.1f} s on {smi.stdout.strip() or 'nvidia-smi failed'}",
          flush=True)
    failed = 0
    for name in names:
        print_ptxas(name, _build.current(name).ptxas())
        if name != "blocktri" and spill_bytes(name):
            failed += 1
            print(f"{name}: a variant spills: FAILED", flush=True)
    for version in built:
        print_ptxas(version.label, version.ptxas())
    f32, f64 = torch.float32, torch.float64
    main_ops = captured_operands(8, 64, 32, 42, f32)
    chunk48 = captured_operands(8, 64, 48, 11, f32)
    cases = [("main path L=64 2N=32 B=1024 f32", main_ops),
             ("main path L=64 2N=32 B=1024 f64", captured_operands(8, 64, 32, 42, f64)),
             ("NQuad=48 chunk L=64 2N=48 B=1024 f32", chunk48),
             ("NQuad=48 chunk L=64 2N=48 B=1024 f64", captured_operands(8, 64, 48, 11, f64))]
    for nquad in (2, 6, 30, 34, 48, 64):
        for dt in (f32, f64):
            cases.append((f"L=16 2N={nquad} B=128 {str(dt)[6:]}", captured_operands(1, 16, nquad, nquad, dt)))
    for nquad in (32, 48):
        cases.append((f"L=1 2N={nquad} B=777 f32 (ragged)",
                      tuple(o[..., :777].contiguous() for o in captured_operands(7, 1, nquad, 6, f32))))
    for nquad in (32, 64):
        cases.append((f"L=5 2N={nquad} B=1001 f64 (ragged)",
                      tuple(o[..., :1001].contiguous() for o in captured_operands(8, 5, nquad, 7, f64))))
    # random systems are worse conditioned than those of real solves (the
    # plain version in float32 loses up to 2.5e-3 per lane at L=8, 2N=32):
    # float32 is held on them where the layers are few and 2N < 64 (at L=1,
    # 2N=64, B=33 it loses 6.6e-4, too close to the limit to tell a fault)
    for L, N, B, dts in ((1, 1, 5, (f32, f64)), (3, 3, 33, (f32, f64)), (1, 16, 300, (f32, f64)),
                         (5, 8, 77, (f64,)), (8, 16, 300, (f64,)), (1, 17, 45, (f32, f64)), (1, 24, 300, (f32, f64)),
                         (1, 32, 33, (f64,)), (6, 24, 70, (f64,)), (4, 32, 9, (f64,)), (3, 25, 5, (f64,))):
        for dt in dts:
            cases.append((f"random dense G L={L} 2N={2 * N} B={B} {str(dt)[6:]}", random_operands(L, N, B, L + N, dt)))
    for label, ops in cases:
        rel = lane_rel_err(ops)
        tol = 1e-3 if ops[0].dtype == f32 else 1e-9
        failed += not rel < tol
        print(f"{label}: per-lane rel {rel:.3e} {'ok' if rel < tol else 'FAILED'} (limit {tol:g})", flush=True)

    timed_routes(main_ops, "L=64 2N=32 B=1024 float32, main-path operands")
    timed_routes(chunk48, "L=64 2N=48 B=1024 float32, the NQuad=48 chunk's operands")
    if built:
        print("kernel 7 versions at the NQuad=48 chunk's operands, C entries, in turns", flush=True)
        ab_versions(built, [("NQuad=48 chunk", ops) for ops in (chunk48, captured_operands(8, 64, 48, 11, f64))])
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
