"""Compile-and-check call for ``csrc/bvp_operands.cu`` on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_operands [--source OTHER.cu ...]

Builds ``bvp_operands`` (and the kernels a radiance step needs) and prints
what ptxas reports for its four variants (float32 and float64, with and
without a beam; a spill fails the check).  Then it holds
`operands.bvp_operands` on the card, which launches the kernel, to
`operands.bvp_operands_plain` run on the card on the same operands:
``Gt`` must have equal bits, and ``B_l`` lie within `B_LIMIT` of the
plain code's (the largest difference of a lane over its largest |B_l|:
the plain code's gemvs sum in cuBLAS's order); every lane of both routes
must be finite (the solve moves mu0 off the beam's pole before it builds
the operands, ``models/disort/solve.py::off_pole``):

- on the operands of a step at the shapes of the benchmark's two
  radiance cells (`CELLS`), captured from ``batch_solve._solve`` in a
  ``make_batched_problem`` -> ``solve_intensity`` step built as the cells
  build theirs, in float64 as the cells run and in float32, with and
  without the beam;
- random operands at the kernel's edges (`EDGES`): n = 1, odd n, n past
  the BVP kernels' widths and at 64, whose shared memory needs the
  launch attribute; lanes not a multiple of a block, L = 1, S = 1.

It counts the launches of one step of each cell (one expected) and checks
the routes: operands that take a gradient or carry a forward-mode tangent
take the plain code (no launch, its bits), under ``no_grad`` the kernel.
It times both routes at each cell's step in turns (plain, kernel,
kernel, plain) with CUDA events, against the bound: the bytes the kernel
must move (X, Y, P, Q, K, xp, xn read once, ``Gt`` and ``B_l`` written
once) at 3.35 TB/s.  Last, `pole_step` holds the guarded float32 flux
step at the shapes of the benchmark's ``sw_flux_f32`` cell, with rows set
on, inside and just outside their beam pole, finite and within that
cell's limit of the float64 step on the card.  ``--source`` builds other
versions of the source (an earlier commit's, an edited copy) with the
package's flags, checks each the same way on the cells' operands and
times it through `bvp_operands` inside ``_build.swapped``.  Exits nonzero if a check
fails.  ``chip_smoke.py`` at the repository root holds the kernel to the
plain code at its own chunks' operands.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..models.disort import batch_solve
from ..ops import _build, operands
from ..utils import profiling
from .check_blocktri import cuda_ms
from .check_bvp import bench_arrays
from .check_legendre import differ
from .check_wide import print_ptxas

# A step of each radiance cell: cell -> (solves S, layers L, NQuad,
# NFourier, moments NLeg_all); n = NQuad / 2 and NF * L * S eigen lanes
CELLS = {"cloud_radiance": (112, 60, 48, 48, 300), "sw_radiance": (448, 60, 32, 16, 33)}
SEED = 20261018
PHI = (0.0, 1.6, 3.1, 4.7)
# kernels a radiance step launches besides this one
STEP_KERNELS = ["eig_stage", "bvp_fused", "bvp_fused_wide", "legendre_series"]
# (n, L, S, NF) at the kernel's edges
EDGES = [(1, 3, 5, 2), (3, 2, 7, 3), (8, 1, 33, 1), (17, 4, 1, 5), (24, 2, 37, 3), (34, 3, 11, 2),
         (64, 2, 9, 2)]
B_LIMIT = {torch.float64: 1e-13, torch.float32: 1e-4}
# `pole_step`: the benchmark's sw_flux_f32 chunk (columns, g-points,
# layers, NQuad), its comparison (a row's largest difference over its
# three fluxes at the layer bottoms, over its largest float64 value, times
# min(1, d / POLE_SCALE), d its least |1 - k mu0|) and that cell's limit;
# the rows set off their pole by these many gaps (0: on it), each sign
POLE_CHUNK, POLE_SCALE, POLE_LIMIT = (8, 224, 60, 32), 1e-3, 1.5e-4
POLE_OFFSETS = (0.0, 0.5, 1.5, 3.0, 10.0, 100.0)
PEAK_BYTES_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
NAMES = ("X", "Y", "P", "Q", "K_full", "L", "S", "xp", "xn", "mu0")


def as_kwargs(args):
    """`bvp_operands`'s positional arguments as keywords."""
    return dict(dict.fromkeys(NAMES), **dict(zip(NAMES, args)))


def cell_operands(cell, seed=SEED, device="cuda", cells=CELLS, dtype=torch.float64):
    """The arguments of `bvp_operands` in one step in ``dtype`` at ``cell``'s
    shapes (a key of ``cells``), and the launches of ``bvp_operands`` in that step: a delta-M
    beam problem with NT corrections from `check_bvp.bench_arrays`' draws
    (Henyey-Greenstein moments), built by ``make_batched_problem`` and
    solved by ``solve_intensity`` with a probe at each layer's bottom and
    four azimuths."""
    import pythonic_disort_torch as pt

    S, L, nquad, nf, nleg_all = cells[cell]
    a = bench_arrays(1, seed=seed, nlayers=L, nquad=nleg_all - 1, nbands=S)
    cfg = pt.DisortConfig(nquad=nquad, nleg=nquad, nleg_all=nleg_all, nfourier=nf, nlayers=L, nscoeffs=0,
                          nbdrf=0, has_beam=True, only_flux=False, has_deltam=True, nt_correct=True)
    prob = pt.make_batched_problem(cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"],
                                   f_arr=a["leg"][..., nquad], dtype=dtype, device=device)
    phi = torch.tensor(PHI, dtype=dtype, device=device).expand(S, len(PHI)).contiguous()
    seen, real = [], batch_solve.bvp_operands

    def record(*args):
        seen.append(as_kwargs(args))
        return real(*args)

    profiling.reset()
    batch_solve.bvp_operands = record
    try:
        pt.solve_intensity(prob, prob.tau_arr * (1 - 1e-6), phi, probes_per_layer=True)
    finally:
        batch_solve.bvp_operands = real
    if prob.tau_arr.is_cuda:
        torch.cuda.synchronize()
    launched = profiling.recorded()["launches"].get("bvp_operands", 0)
    del prob
    torch.cuda.empty_cache()
    return seen[0], launched


def random_operands(n, L, S, NF, dtype, seed):
    rng = np.random.default_rng(seed)
    lanes = NF * L * S
    t = lambda x: torch.as_tensor(x, dtype=dtype, device="cuda")
    K = rng.uniform(0.5, 3.0, (n, lanes))
    return dict(X=t(rng.normal(size=(n, n, lanes))), Y=t(rng.normal(size=(n, n, lanes))),
                P=t(rng.normal(size=(n, n, lanes))), Q=t(rng.normal(size=(n, n, lanes))),
                K_full=t(np.concatenate([-K, K])), L=L, S=S, xp=t(rng.normal(size=(n, lanes))),
                xn=t(rng.normal(size=(n, lanes))), mu0=t(rng.uniform(0.2, 1.0, S)))


def without_beam(ops):
    return dict(ops, xp=None, xn=None, mu0=None)


def lane_rel(B, ref):
    """The largest difference of a lane over its largest |ref| (0 where
    the lane is 0 in both); infinite where a lane of either is not finite."""
    scale = ref.abs().amax(dim=0)
    d = (B - ref).abs().amax(dim=0)
    rel = d / torch.where(scale > 0, scale, torch.ones_like(scale))
    finite = torch.isfinite(B).all(dim=0) & torch.isfinite(ref).all(dim=0)
    rel = torch.where(finite, rel, torch.full_like(rel, float("inf")))
    return float(rel.max()) if rel.numel() else 0.0


def check_bits(label, ops, version=None):
    """The kernel (or ``version`` in its place) against the plain code on
    the card: (ok, B_l's largest difference of a lane over its largest,
    0 without a beam); ok if ``Gt`` has equal bits, one launch ran and
    ``B_l`` is within `B_LIMIT`."""
    profiling.reset()
    with _build.swapped(version) if version is not None else contextlib.nullcontext():
        Gt, B = operands.bvp_operands(**ops)
    torch.cuda.synchronize()
    launched = profiling.recorded()["launches"].get("bvp_operands", 0)
    Gp, Bp = operands.bvp_operands_plain(**ops)
    bad = differ(Gt, Gp)
    ok, rel = not bad and launched == 1, 0.0
    line = f"{label}: Gt {'equal bits' if not bad else bad}; launches {launched}"
    if Bp is not None:
        rel = lane_rel(B, Bp)
        ok = ok and rel <= B_LIMIT[Bp.dtype]
        line += f"; B_l {rel:.3e} of its lane's largest (limit {B_LIMIT[Bp.dtype]:.0e})"
        bad = [int((~torch.isfinite(x).all(dim=0)).sum()) for x in (B, Bp)]
        if any(bad):
            line += f"; lanes not finite: {bad[0]} in the kernel's, {bad[1]} in the plain code's"
    print(f"{line} {'ok' if ok else 'FAILED'}", flush=True)
    del Gt, B, Gp, Bp
    return ok, rel


def check_routes():
    """A gradient or a forward-mode tangent keeps the plain code on the
    card (no launch, its bits); ``no_grad`` takes the kernel."""
    ops = random_operands(4, 3, 5, 2, torch.float64, 1)
    leaf = dict(ops, X=ops["X"].clone().requires_grad_())
    profiling.reset()
    Gt, B = operands.bvp_operands(**leaf)
    g = torch.autograd.grad(Gt.sum() + B.sum(), leaf["X"])[0]
    Gp, Bp = operands.bvp_operands_plain(**leaf)
    gp = torch.autograd.grad(Gp.sum() + Bp.sum(), leaf["X"])[0]
    n_grad = profiling.recorded()["launches"].get("bvp_operands", 0)
    ok_grad = n_grad == 0 and not differ(Gt.detach(), Gp.detach()) and not differ(g, gp)
    with fwAD.dual_level():
        dual = dict(ops, X=fwAD.make_dual(ops["X"], torch.ones_like(ops["X"])))
        profiling.reset()
        got = [fwAD.unpack_dual(x) for x in operands.bvp_operands(**dual)]
        n_fw = profiling.recorded()["launches"].get("bvp_operands", 0)
        want = [fwAD.unpack_dual(x) for x in operands.bvp_operands_plain(**dual)]
    ok_fw = n_fw == 0 and not any(differ(a.primal, b.primal) or differ(a.tangent, b.tangent)
                                  for a, b in zip(got, want))
    profiling.reset()
    with torch.no_grad():
        operands.bvp_operands(**leaf)
    n_ng = profiling.recorded()["launches"].get("bvp_operands", 0)
    print(f"routes: gradient {n_grad} launches, outputs and d/dX the plain code's bits "
          f"{'ok' if ok_grad else 'FAILED'}; forward mode {n_fw} launches, primal and tangent the plain code's "
          f"{'ok' if ok_fw else 'FAILED'}; no_grad {n_ng} launch {'ok' if n_ng == 1 else 'FAILED'}", flush=True)
    return ok_grad + ok_fw + (n_ng == 1) == 3


def bound_ms(ops):
    """The bytes the kernel must move at the card's rate: every operand
    it reads once, ``Gt`` (four times X) and ``B_l`` written once."""
    X = ops["X"]
    reads = sum(v.numel() for k, v in ops.items()
                if isinstance(v, torch.Tensor) and (k in ("X", "Y", "K_full") or ops["xp"] is not None))
    writes = 4 * X.numel() + (2 * X.shape[0] * X.shape[2] if ops["xp"] is not None else 0)
    return 1e3 * (reads + writes) * X.element_size() / PEAK_BYTES_S


def time_cell(label, ops, versions):
    """Plain code and kernel (and each other version through the same
    wrapper) at one step's operands, in turns: ms a call."""
    runs = {"plain": lambda: operands.bvp_operands_plain(**ops),
            "kernel": lambda: operands.bvp_operands(**ops)}
    for v in versions:
        def other(v=v):
            with _build.swapped(v):
                return operands.bvp_operands(**ops)
        runs[v.label] = other
    order = ["plain", "kernel", *(v.label for v in versions)]
    times = {}
    for route in order + order[::-1]:
        times.setdefault(route, []).append(round(cuda_ms(runs[route], 3 if route == "plain" else 10), 4))
    b = bound_ms(ops)
    best = min(times["kernel"])
    parts = ", ".join(f"{r} {t} ms" for r, t in times.items())
    print(f"  {label}: {parts}; bound {b:.4f} ms (bytes), kernel at {100 * b / best:.1f} % of it, "
          f"{min(times['plain']) / best:.1f}x the plain code", flush=True)


def pole_step(seed=SEED, device="cuda", chunk=POLE_CHUNK):
    """The guarded float32 flux step at ``sw_flux_f32``'s shapes (``chunk``)
    against the float64 step on ``device``, with rows set on their beam
    pole (mu0 = 1/k to float32's rounding, k one of the row's float32
    eigenvalues in (1, 5)) and at `POLE_OFFSETS` gaps off it, the others as
    drawn; prints, for each set of rows, the solves moved, the float64
    pole distance and the errors, and counts the moved solves that no move
    put a gap off every k.  Ok if every output is finite and every row is
    within `POLE_LIMIT` after the cell's scaling."""
    import pythonic_disort_torch as pt
    from ..models.disort import solve as single

    cols, bands, L, nquad = chunk
    a = bench_arrays(cols, seed=seed, nlayers=L, nquad=nquad, nbands=bands)
    S, gap = cols * bands, single.POLE_GAP[torch.float32]
    seen, real = [], batch_solve.off_pole

    def record(mu0, k):
        out = real(mu0, k)
        seen.append((k.detach().double().cpu(), out[0].detach().double().cpu(), out[1].cpu()))
        return out

    def fluxes(mu0, dtype):
        prob = pt.make_batched_problem(
            pt.DisortConfig(nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=1, nlayers=L, nscoeffs=0,
                            nbdrf=0, has_beam=True, only_flux=True, has_deltam=True),
            a["tau"], a["omega"], a["leg"], mu0, a["I0"], f_arr=a["f_arr"], dtype=dtype, device=device)
        out = pt.solve_fluxes(prob, prob.tau_arr)
        return torch.stack([x.double().cpu() for x in out], dim=1)          # (S, 3, L)

    batch_solve.off_pole = record
    try:
        fluxes(a["mu0"], torch.float32)
        k32 = seen.pop()[0]                                                  # (M, S)
        rng = np.random.default_rng(seed)
        mu0 = np.float32(a["mu0"]).astype(np.float64)
        group = np.arange(S) % (len(POLE_OFFSETS) + 1)                       # the last: rows as drawn
        for s in range(S):
            if group[s] < len(POLE_OFFSETS):
                ks = k32[:, s][(k32[:, s] > 1.0) & (k32[:, s] < 5.0)].numpy()
                off = POLE_OFFSETS[group[s]] * gap * (1 if s % 2 else -1)
                mu0[s] = np.float32((1.0 + off) / np.float32(ks[rng.integers(len(ks))]))
        got = fluxes(mu0, torch.float32)
        k, moved_mu0, moved = seen.pop()
        want = fluxes(mu0, torch.float64)
        k64 = seen.pop()[0]
    finally:
        batch_solve.off_pole = real
    finite = bool(torch.isfinite(got).all())
    d64 = (1.0 - k64 * torch.as_tensor(mu0)).abs().amin(dim=0).numpy()
    landed = ((1.0 - k * moved_mu0).abs().amin(dim=0) >= gap * (1 - 1e-3)).numpy()
    err = ((got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2))).numpy()
    scaled = err * np.minimum(1.0, d64 / POLE_SCALE)
    moved = moved.numpy()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip() if device == "cuda" else "-"
    print(f"pole step (sw_flux_f32's chunk: {S} solves, L = {L}, NQuad = {nquad}, float32 against float64, "
          f"{device}, {smi}); gap {gap:g}; every output finite: {finite}", flush=True)
    for g in range(len(POLE_OFFSETS) + 1):
        sel = group == g
        what = f"{POLE_OFFSETS[g]:g} gaps off a pole" if g < len(POLE_OFFSETS) else "as drawn"
        print(f"  {what}: {int(sel.sum())} rows, {int(moved[sel].sum())} moved, d64 {d64[sel].min():.2e}-"
              f"{d64[sel].max():.2e}; error max {err[sel].max():.3e} (median {np.median(err[sel]):.2e}), "
              f"scaled max {scaled[sel].max():.3e}", flush=True)
    stuck = int((moved & ~landed).sum())
    ok = finite and float(scaled.max()) <= POLE_LIMIT
    print(f"  {int(moved.sum())} of {S} solves moved, {stuck} of them with no move landing a gap off every k; "
          f"largest scaled error {scaled.max():.3e} at d64 {d64[scaled.argmax()]:.2e} (limit {POLE_LIMIT:g}), "
          f"largest error {err.max():.3e} at d64 {d64[err.argmax()]:.2e} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", nargs="*", default=[], help="other versions of csrc/bvp_operands.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_operands: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    wait = _build.start(["bvp_operands", *STEP_KERNELS],
                        [(f"--source {p}", "bvp_operands", Path(p).read_text()) for p in args.source])
    versions = wait()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"built in {time.perf_counter() - t0:.1f} s on {smi.stdout.strip() or 'nvidia-smi failed'}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    failed = 0
    for build in [_build.current("bvp_operands"), *versions]:
        variants = build.ptxas()
        print_ptxas(build.label, variants)
        failed += sum(v.spill_stores + v.spill_loads > 0 for v in variants) + (len(variants) != 4)
    for n, L, S, NF in EDGES:
        for dtype in (torch.float64, torch.float32):
            ops = random_operands(n, L, S, NF, dtype, n + L + S)
            name = f"n={n} L={L} S={S} NF={NF} {str(dtype)[6:]}"
            failed += (not check_bits(name, ops)[0]) + (not check_bits(f"{name} no beam", without_beam(ops))[0])
    failed += not check_routes()
    for cell in CELLS:
        ops, launched = cell_operands(cell)
        X = ops["X"]
        print(f"{cell}: a step's operands n = {X.shape[0]}, L = {ops['L']}, S = {ops['S']}, "
              f"{X.shape[2]} lanes, {X.dtype}; bvp_operands launches in a step: {launched} "
              f"{'ok' if launched == 1 else 'FAILED'}", flush=True)
        failed += launched != 1
        failed += not check_bits(f"{cell} float64", ops)[0]
        for v in versions:
            failed += not check_bits(f"{cell} float64 {v.label}", ops, v)[0]
        failed += not check_bits(f"{cell} float64 no beam", without_beam(ops))[0]
        time_cell(f"{cell} float64", ops, versions)
        del ops
        torch.cuda.empty_cache()
        ops32, launched = cell_operands(cell, dtype=torch.float32)
        failed += launched != 1
        failed += not check_bits(f"{cell} float32", ops32)[0]
        failed += not check_bits(f"{cell} float32 no beam", without_beam(ops32))[0]
        time_cell(f"{cell} float32", ops32, [])
        del ops32
        torch.cuda.empty_cache()
    failed += not pole_step()
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
