"""Compile-and-check call for ``csrc/bvp_fused.cu`` (kernel 2) on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_bvp

The short loop after a change to the fused boundary-value kernel: builds
``bvp_fused`` and ``blocktri`` alone (seconds), prints what ptxas reports
for both in float32 and float64, and holds kernel 2 to its plain version
in float64, per lane, at the limits of ``chip_smoke.py``'s ``bvp_checks``
(1e-3 in float32, 1e-9 in float64):

- on the operands of real solves, captured from ``solve_fluxes`` on
  problems of ``bench.py``'s generator built by ``make_batched_problem``
  (float64 on the CPU up to the BVP, so no other kernel is built):
  the main-path shape (L = 64, 2N = 32, B = 1024) in float32 and float64,
  2N = 2, 6 and 30, L = 1 and L = 5 at ragged B (777, 1001);
- on random operands with a dense G whose diagonal is not dominant, so
  that partial pivoting picks rows off the diagonal.

Then it times, with CUDA events at L = 64, 2N = 32, B = 1024 in float32 on
the main-path operands: kernel 2; the route it replaces,
``assemble_bvp_blocks`` + kernel 3; and kernel 3 alone on the assembled
blocks.  Exits nonzero if a check fails.  ``chip_smoke.py`` at the
repository root is the full run.
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.blocktri import assemble_bvp_blocks
from ..ops.cuda_blocktri import solve_block_tridiag_lanes_cuda, solve_bvp_fused, solve_bvp_fused_plain
from .check_blocktri import cuda_ms

# ptxas's report of one kernel variant: the template arguments are the
# mangled part (f/d for float/double, then LiNE for each integer N)
_PTXAS = re.compile(
    r"Compiling entry function '\S*?kernelI(\w+?)EvP\S*' for.*?(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads.*?Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", re.S)


def ptxas_entries(name):
    """(template arguments, registers, stack B, spill stores B, spill loads B,
    static shared B) of every kernel variant in ``csrc/<name>.cu``'s build
    report."""
    report = _build._target(name).with_suffix(".log").read_text()
    return [(args, int(regs), int(stack), int(st), int(ld), int(smem or 0))
            for args, stack, st, ld, regs, smem in _PTXAS.findall(report)]


def spill_bytes(name):
    """Bytes spilled (stores plus loads) over every variant of ``name``."""
    return sum(st + ld for _, _, _, st, ld, _ in ptxas_entries(name))


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


def bench_problem(ncols, nlayers, nquad, seed):
    """A flux-only delta-M beam problem of `bench_arrays` (NQuad = nquad),
    built by ``make_batched_problem`` in float64 on the CPU."""
    import pythonic_disort_torch as pt

    a = bench_arrays(ncols, seed=seed, nlayers=nlayers, nquad=nquad)
    cfg = pt.DisortConfig(
        nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=1, nlayers=nlayers,
        nscoeffs=0, nbdrf=0, has_beam=True, only_flux=True, has_deltam=True)
    return pt.make_batched_problem(cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"],
                                   f_arr=a["f_arr"], dtype=torch.float64, device="cpu")


def captured_operands(ncols, nlayers, nquad, seed, dtype):
    """The operands ``solve_fluxes`` hands the fused kernel on a
    `bench_problem` (2N = nquad <= 32), solved up to the BVP in float64 on
    the CPU (no other kernel is built), as ``dtype`` on the card."""
    import pythonic_disort_torch as pt
    from ..models.disort import batch_solve

    prob = bench_problem(ncols, nlayers, nquad, seed)
    seen = []

    def record(*ops):
        seen.append(tuple(o.to("cuda", dtype).contiguous() for o in ops))
        return torch.zeros_like(ops[3])   # the fluxes are not wanted

    batch_solve.solve_bvp_fused = record
    try:
        pt.solve_fluxes(prob, prob.tau_arr)
    finally:
        batch_solve.solve_bvp_fused = solve_bvp_fused
    return seen[-1]


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


def lane_rel_err(ops):
    """Largest per-lane error of kernel 2's x against the float64 plain solve."""
    x = solve_bvp_fused(*ops)
    torch.cuda.synchronize()
    ref = solve_bvp_fused_plain(*(o.double() for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


def main():
    if not torch.cuda.is_available():
        print("check_bvp: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(["bvp_fused", "blocktri"])
    print(f"built bvp_fused, blocktri in {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}",
          flush=True)
    for name in ("bvp_fused", "blocktri"):
        for args, regs, stack, st, ld, smem in ptxas_entries(name):
            print(f"ptxas {name}<{args}>: {regs} registers, stack {stack} B, spill stores {st} B, "
                  f"spill loads {ld} B, static shared {smem} B", flush=True)
    f32, f64 = torch.float32, torch.float64
    main_ops = captured_operands(8, 64, 32, 42, f32)
    cases = [("main path L=64 2N=32 B=1024 f32", main_ops),
             ("main path L=64 2N=32 B=1024 f64", captured_operands(8, 64, 32, 42, f64))]
    for nquad in (2, 6, 30):
        for dt in (f32, f64):
            cases.append((f"L=16 2N={nquad} B=128 {str(dt)[6:]}", captured_operands(1, 16, nquad, nquad, dt)))
    cases.append(("L=1 2N=32 B=777 f32 (ragged)",
                  tuple(o[..., :777].contiguous() for o in captured_operands(7, 1, 32, 6, f32))))
    cases.append(("L=5 2N=32 B=1001 f64 (ragged)",
                  tuple(o[..., :1001].contiguous() for o in captured_operands(8, 5, 32, 7, f64))))
    # random systems are worse conditioned than those of real solves (the
    # plain version in float32 loses up to 2.5e-3 per lane at L=8, 2N=32):
    # float32 is held on them where the layers are few
    for L, N, B, dts in ((1, 1, 5, (f32, f64)), (3, 3, 33, (f32, f64)), (1, 16, 300, (f32, f64)),
                         (5, 8, 77, (f64,)), (8, 16, 300, (f64,))):
        for dt in dts:
            cases.append((f"random dense G L={L} 2N={2 * N} B={B} {str(dt)[6:]}", random_operands(L, N, B, L + N, dt)))
    failed = 0
    for label, ops in cases:
        rel = lane_rel_err(ops)
        tol = 1e-3 if ops[0].dtype == f32 else 1e-9
        failed += not rel < tol
        print(f"{label}: per-lane rel {rel:.3e} {'ok' if rel < tol else 'FAILED'} (limit {tol:g})", flush=True)

    blocks = assemble_bvp_blocks(*main_ops[:3])
    fused_ms = cuda_ms(lambda: solve_bvp_fused(*main_ops), 20)
    route_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*assemble_bvp_blocks(*main_ops[:3]), main_ops[3]), 20)
    k3_ms = cuda_ms(lambda: solve_block_tridiag_lanes_cuda(*blocks, main_ops[3]), 20)
    print(f"L=64 2N=32 B=1024 float32, main-path operands: bvp_fused {fused_ms:.4f} ms; "
          f"assemble_bvp_blocks + blocktri {route_ms:.4f} ms; blocktri alone {k3_ms:.4f} ms", flush=True)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
