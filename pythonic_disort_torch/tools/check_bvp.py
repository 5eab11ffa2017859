"""Compile-and-check call for the fused boundary-value kernel on one NVIDIA
GPU: ``csrc/bvp_fused_wide.cu`` (kernel 7) at every even 2N <= 64, in its
capacities NC = 16, 32 (the narrow ones) and 48, 64.

    python3 -m pythonic_disort_torch.tools.check_bvp [--source OTHER.cu ...]

The short loop after a change to the kernel, and its A/B loop: builds
``bvp_fused_wide``, ``blocktri`` and the kernels of the solve up to the
BVP (one nvcc each, started together), prints what ptxas reports for
every variant of the first two in float32 and float64 (a variant of the
fused solve that spills fails the check), and holds the kernel to the
float64 plain version, per lane, at the limits of ``chip_smoke.py``'s
``bvp_checks`` (1e-3 in float32, 1e-9 in float64):

- on the operands of real solves, captured from ``solve_fluxes`` on
  problems of ``bench.py``'s generator built by ``make_batched_problem``
  (solved up to the BVP in float64 on the card): the
  main-path shape (L = 60, 2N = 32, B = 1024) and the NQuad=48 chunk's
  (L = 64, 2N = 48, B = 1024) in float32 and float64; 2N = 2, 6, 16, 30,
  34, 48 and 64 at L = 16; L = 1 and L = 5 at ragged B (777, 1001); a
  ragged batch with one lane of NaN operands, whose neighbours in its
  block stay within the limits; the four cells' shapes at 2N = 32 (the
  main-path lanes repeated: L = 60, B = 7168 and 1792 in float64, 1792 and
  2048 in float32);
- on random operands with a dense G whose diagonal is not dominant, so
  that partial pivoting picks rows off the diagonal, at 2N up to 64.

Then it times, with CUDA events: the kernel, the route it replaced
(``assemble_bvp_blocks`` + kernel 3) and kernel 3 alone on the assembled
blocks at the main-path shape and the NQuad=48 chunk's, in float32; and
the kernel and its plain version at the four cells' shapes.  With
``--source``, each named version of the fused solve is built beside the
tree's: another ``bvp_fused_wide.cu`` (an earlier commit's via ``git show
<rev>:pythonic_disort_torch/csrc/bvp_fused_wide.cu > build/old.cu``, or an
edited copy that skips a stage), or a source with kernel 2's C interface
(``bvp_fused_f32``, ``bvp_fused_f64``: the same arguments, the entry points
renamed here; kernel 2 was ``csrc/bvp_fused.cu`` until it was retired:
``git show <rev>:pythonic_disort_torch/csrc/bvp_fused.cu > build/k2.cu``).
Its ptxas report and its per-lane error at each timed shape are printed
(not counted: a copy that skips a stage is wrong by design), and all
versions, the tree's first, are timed in turns through their C entries at
the four cells' shapes and at the NQuad=48 chunk's operands in float32 and
float64.  Exits nonzero if a check of the tree's kernel fails.
``chip_smoke.py`` at the repository root is the full run.
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
from ..ops.cuda_blocktri import solve_block_tridiag_lanes_cuda, solve_bvp_fused, solve_bvp_fused_plain
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

    prob = batched_problem(bench_arrays(ncols, seed=seed, nlayers=nlayers, nquad=nquad), nquad, torch.float64, "cuda")
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
MAIN = (8, 60, 32, 42)
CAPTURED = [MAIN, (8, 64, 48, 11), *((1, 16, q, q) for q in (2, 6, 16, 30, 34, 48, 64)),
            (7, 1, 32, 6), (7, 1, 48, 6), (8, 5, 32, 7), (8, 5, 64, 7)]
# the cells that run the fused solve at 2N = 32: (name, lanes, dtype name);
# L = 60 in each
CELLS = [("sw_radiance", 7168, "float64"), ("sw_flux", 1792, "float64"), ("sw_flux_f32", 1792, "float32"),
         ("lw_flux_temper", 2048, "float32")]


def captured_operands(ncols, nlayers, nquad, seed, dtype):
    """The operands ``solve_fluxes`` hands the fused solve on a
    `bench_problem`'s arrays (2N = nquad <= 64), solved up to the BVP in
    float64 on the card once, as ``dtype``."""
    return tuple(o.to(dtype).contiguous() for o in _captured_f64(ncols, nlayers, nquad, seed))


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


def lanes(ops, B):
    """``ops`` with their lanes repeated (or cut) to ``B``."""
    reps = -(-B // ops[0].shape[-1])
    return tuple(o.repeat(*(1,) * (o.dim() - 1), reps)[..., :B].contiguous() for o in ops)


def lane_rel(x, ops):
    """Largest per-lane error of ``x`` against the float64 plain solve of
    ``ops``, relative to the lane's largest |x| there; inf if ``x`` is not
    finite."""
    torch.cuda.synchronize()
    ref = solve_bvp_fused_plain(*(o.double() for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


def lane_rel_err(ops):
    """`lane_rel` of the fused solve through its wrapper."""
    return lane_rel(solve_bvp_fused(*ops), ops)


def nan_lane_check(ops, b):
    """The fused solve on ``ops`` with lane ``b``'s operands NaN: `lane_rel`
    of every other lane (the NaN lane's x is not finite, and no other lane
    reads it) and whether lane ``b`` came back non-finite."""
    nan = tuple(o.clone() for o in ops)
    for o in nan:
        o[..., b] = float("nan")
    x = solve_bvp_fused(*nan)
    keep = [j for j in range(ops[0].shape[-1]) if j != b]
    return lane_rel(x[..., keep], tuple(o[..., keep] for o in ops)), not bool(torch.isfinite(x[..., b]).all())


def timed_routes(ops, label):
    """CUDA-event ms of the fused solve, of the route it replaces
    (``assemble_bvp_blocks`` + kernel 3) and of kernel 3 alone on the
    assembled blocks, on ``ops``; printed under ``label``."""
    blocks = assemble_bvp_blocks(*ops[:3])
    fused_ms = cuda_ms(lambda: solve_bvp_fused(*ops), 20)
    route_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(*ops[:3]), ops[3]), 20)
    k3_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*blocks, ops[3]), 20)
    print(f"{label}: bvp_fused_wide {fused_ms:.4f} ms; assemble_bvp_blocks + blocktri {route_ms:.4f} ms; "
          f"blocktri alone {k3_ms:.4f} ms", flush=True)
    return fused_ms, route_ms, k3_ms


def as_kernel7(text):
    """A source of the fused solve with kernel 7's C entry points: kernel
    2's (``bvp_fused_f32``, ``_f64``; the same arguments) renamed."""
    for suffix in ("f32", "f64"):
        text = text.replace(f"int bvp_fused_{suffix}(", f"int bvp_fused_wide_{suffix}(")
    return text


def ab_versions(built, cases):
    """The tree's kernel and the ``--source`` versions on each case
    (label, ops): per-lane error through their C entries (printed; a
    version whose entry refuses the case is left out of it), then
    `check_blocktri.time_versions` in turns."""
    versions = [_build.current("bvp_fused_wide"), *built]
    for label, ops in cases:
        takes = []
        for version in versions:
            call, x = entry_call(version.entry(ops[0].dtype), ops, fused=True)
            err = call()
            rel = float("inf") if err else lane_rel(x, ops)
            takes += [version] if not err else []
            print(f"  {version.label} {label} {str(ops[0].dtype)[6:]}: "
                  f"{f'refused (CUDA error {err})' if err else f'per-lane rel {rel:.3e}'}", flush=True)
        time_versions(takes, [(label, ops)], fused=True)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", nargs="*", default=[],
                        help="other versions of the fused solve (kernel 7's or kernel 2's C interface) to time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_bvp: CUDA is not available", file=sys.stderr)
        return 2
    from pathlib import Path

    from .check_wide import print_ptxas

    names = ("bvp_fused_wide", "blocktri")
    t0 = time.perf_counter()
    # and the kernels that solve the captured problems up to the BVP
    pending = _build.start(names + ("eig_stage", "jacobi_eigh_wide", "bvp_operands"),
                           [(path, "bvp_fused_wide", as_kernel7(Path(path).read_text())) for path in args.source])
    built = pending()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"built in {time.perf_counter() - t0:.1f} s on {smi.stdout.strip() or 'nvidia-smi failed'}", flush=True)
    for args in CAPTURED:
        _captured_f64(*args)
    print(f"captured {len(CAPTURED)} sets of operands on the card in float64", flush=True)
    failed = 0
    for name in names:
        print_ptxas(name, _build.current(name).ptxas())
    if spill_bytes("bvp_fused_wide"):
        failed += 1
        print("bvp_fused_wide: a variant spills: FAILED", flush=True)
    for version in built:
        print_ptxas(version.label, version.ptxas())
    f32, f64 = torch.float32, torch.float64
    main_ops = captured_operands(*MAIN, f32)
    chunk48 = captured_operands(8, 64, 48, 11, f32)
    cases = [("main path L=60 2N=32 B=1024 f32", main_ops),
             ("main path L=60 2N=32 B=1024 f64", captured_operands(*MAIN, f64)),
             ("NQuad=48 chunk L=64 2N=48 B=1024 f32", chunk48),
             ("NQuad=48 chunk L=64 2N=48 B=1024 f64", captured_operands(8, 64, 48, 11, f64))]
    # the main-path lanes repeated to each cell's shape
    cells = [(f"{name} L=60 2N=32 B={B} {dt}", lanes(captured_operands(*MAIN, getattr(torch, dt)), B))
             for name, B, dt in CELLS]
    cases += cells
    for nquad in (2, 6, 16, 30, 34, 48, 64):
        for dt in (f32, f64):
            cases.append((f"L=16 2N={nquad} B=128 {str(dt)[6:]}", captured_operands(1, 16, nquad, nquad, dt)))
    for nquad in (32, 48):
        cases.append((f"L=1 2N={nquad} B=777 f32 (ragged)",
                      tuple(o[..., :777].contiguous() for o in captured_operands(7, 1, nquad, 6, f32))))
    for nquad in (32, 64):
        cases.append((f"L=5 2N={nquad} B=1001 f64 (ragged)",
                      tuple(o[..., :1001].contiguous() for o in captured_operands(8, 5, nquad, 7, f64))))
    cases.append(("L=16 2N=16 B=77 f32 (ragged)", lanes(captured_operands(1, 16, 16, 16, f32), 77)))
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
    # one lane of NaN operands in each variant's block: lane 5 of 777
    # (f32) and 1001 (f64) lanes, at each capacity
    for nquad, dt in ((2, f64), (16, f32), (32, f64), (32, f32), (48, f64), (64, f32)):
        B = 777 if dt == f32 else 1001
        ops = lanes(captured_operands(1, 16, nquad, nquad, dt) if nquad != 32 else captured_operands(*MAIN, dt), B)
        rel, nan_out = nan_lane_check(ops, 5)
        tol = 1e-3 if dt == f32 else 1e-9
        ok = rel < tol and nan_out
        failed += not ok
        print(f"L={ops[0].shape[0]} 2N={nquad} B={B} {str(dt)[6:]}, lane 5 NaN: the other lanes' per-lane rel "
              f"{rel:.3e}, lane 5 {'non-finite' if nan_out else 'FINITE'} {'ok' if ok else 'FAILED'}", flush=True)

    timed_routes(main_ops, "L=60 2N=32 B=1024 float32, main-path operands")
    timed_routes(chunk48, "L=64 2N=48 B=1024 float32, the NQuad=48 chunk's operands")
    for label, ops in cells:
        ms = cuda_ms(lambda: solve_bvp_fused(*ops), 5)
        plain = cuda_ms(lambda: solve_bvp_fused_plain(*ops), 1)
        print(f"{label}: bvp_fused_wide {ms:.4f} ms; plain {plain:.3f} ms", flush=True)
    if built:
        print("versions at the cells' shapes and the NQuad=48 chunk's operands, C entries, in turns", flush=True)
        ab_versions(built, [*cells, *(("NQuad=48 chunk", ops) for ops in
                                       (chunk48, captured_operands(8, 64, 48, 11, f64)))])
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
