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
in float32 against the port's float64 CPU result; times the kernels with
CUDA events through their C entry points (outputs allocated once):
kernel 5 at the shapes of `JACOBI_TIMED` (the batched NQuad=68 chunk's
M, n=34, B=16384, in float32 and float64; the lanes of the NQuad = 68,
128 and 30 columns; an odd n at the chunk's lane count), kernel 6 at the
shapes of `BT_TIMED` (the chunk's blocks, L=64, n=68, B=256, and the
columns', L=16, n=68, B=68 at NQuad=68 and L=8, n=128, B=16 at
NQuad=128, float32; then float64, an odd n and 68 < n < 128) and on
the two sets of blocks of a 64-layer NQuad=68 column gradient.  Exits
nonzero if a check fails.  `chip_smoke.py` at the repository root is the
full run.

    python3 -m pythonic_disort_torch.tools.check_wide --jacobi-source OTHER.cu ...

The A/B loop for kernel 5: builds each named version of
``jacobi_eigh_wide.cu`` (the same C interface; an earlier commit's via
``git show <rev>:pythonic_disort_torch/csrc/jacobi_eigh_wide.cu``) in
parallel with the tree's, prints its ptxas registers and spills, holds it
to the float64 eigenvalues and the orthogonality and reconstruction
readings under `wide_limits` at every shape of `JACOBI`, and times all
versions in turns at `JACOBI_TIMED`; kernel 6 is then checked but not
timed, unless ``--source`` or ``--split`` is given too.

    python3 -m pythonic_disort_torch.tools.check_wide --source OTHER.cu ... --split BASE.cu ...

The A/B loop for kernel 6.  ``--source`` builds each named version of
``blocktri_wide.cu`` (the same C interface; an earlier commit's via
``git show <rev>:pythonic_disort_torch/csrc/blocktri_wide.cu``), holds
it to the plain version at the chunk shape in both types and times it
beside the kernel.
``--split`` makes, from each named base source, one copy per entry of
`SPLIT_EDITS` of the base's kind (a stage skipped or its loads made
cache hits, so its results are wrong and not checked; an edit whose text
the base lacks stops the tool), builds them
under ``build/`` and times them too: the time a stage takes is the
base's time less the copy's.  Every version is built in parallel with
its own nvcc, its ptxas registers and spills are printed, and all are
timed in turns (versions, then the same in reverse order) in one
process.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops.blocktri import solve_block_tridiag_lanes
from ..ops.cuda_blocktri import solve_block_tridiag_lanes_wide as blocktri_wide
from ..ops.cuda_jacobi import jacobi_eigh_lanes_wide as jacobi_wide
from ..ops.cuda_jacobi import slot_table
from ..ops.jacobi import default_sweeps
from .check_blocktri import random_blocks
from .check_jacobi import LIMITS, check_readings, cuda_ms, eigvalsh64, readings, scan_matrices


def wide_limits(n, dtype):
    """Kernel 5's limits on the readings of `check_jacobi.readings`: kernel
    4's (`check_jacobi.LIMITS`, set at n <= 32) times max(1, n / 32).  Each
    entry of V is the product of about n rotations per sweep, so the
    roundoff of a float32 Jacobi grows with n: the plain version in float32
    reconstructs the ramp matrices of `check_jacobi.scan_matrices` to about
    5e-5 at n = 128 (`chip_smoke.py` phase 3 logs its readings beside the
    kernel's)."""
    return {k: v * max(1.0, n / 32) for k, v in LIMITS[dtype].items()}


# kernel 5's checked shapes (n, B): every variant of the register body at a
# ragged B, with one block's worth of lanes and with enough for its wide
# blocks (15 at 8500, 34 and 64 at 2201), and the general body at 128
JACOBI = [(1, 5), (2, 7), (3, 33), (15, 8500), (17, 100), (31, 9), (33, 40), (34, 65), (34, 2201), (64, 17),
          (64, 2201), (128, 3)]
BLOCKTRI = [(1, 1, 4), (3, 5, 6), (3, 66, 5), (2, 68, 3), (8, 68, 9), (2, 68, 1), (3, 67, 5), (2, 99, 3),
            (2, 128, 3), (2, 136, 2), (2, 256, 2)]
BT_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}
# kernel 5's timed shapes on the random matrices of `scan_matrices`:
# (label, n, B, dtype).  The batched NQuad=68 chunk's M in both types, the
# lanes of the pydisort columns at NQuad = 68 (16 layers x 68 modes), 128
# (8 x 16) and 30 (64 x 30), and an odd n at the chunk's lane count.
JACOBI_TIMED = [("NQuad=68 chunk", 34, 16384, torch.float32), ("NQuad=68 chunk", 34, 16384, torch.float64),
                ("NQuad=68 column", 34, 1088, torch.float32), ("NQuad=128 column", 64, 128, torch.float32),
                ("NQuad=30 column", 15, 1920, torch.float32), ("odd n", 33, 16384, torch.float32)]
# kernel 6's timed shapes on random dense blocks: (label, L, n, B, dtype).
# The NQuad=68 chunk's blocks and the columns' of NQuad = 68 and 128 in
# float32, then the other routes of the register tile: the chunk and the
# NQuad=68 column in float64, an odd n, and 68 < n < 128 in float32.
BT_TIMED = [("NQuad=68 chunk", 64, 68, 256, torch.float32), ("NQuad=68 column", 16, 68, 68, torch.float32),
            ("NQuad=128 column", 8, 128, 16, torch.float32), ("NQuad=68 chunk", 64, 68, 256, torch.float64),
            ("NQuad=68 column", 16, 68, 68, torch.float64), ("odd n", 64, 67, 256, torch.float32),
            ("n = 69", 64, 69, 256, torch.float32), ("n = 99", 64, 99, 256, torch.float32),
            ("n = 99, few lanes", 16, 99, 16, torch.float32)]

# The --split copies: name -> (text, replacement) pairs, each applied to a
# base source that holds every text once.  "tile" edits the register tile;
# "general" edits the file of commit 768065d, before the register tile
# (its entries reproduce that kernel's stage split).  A base with a
# register tile takes the "tile" entries, any other the "general" ones.
_PRE_TILE_CORRECTION = [("    if (l > 0) {\n      // [dhat | rhat]", "    if (false) {\n      // [dhat | rhat]")]
_PRE_TILE_ELIMINATION = [
    ("for (int k = 0; k < n; ++k) {\n      __syncthreads();", "for (int k = 0; k < 0; ++k) {\n      __syncthreads();"),
    ("var[i] = -1;", "var[i] = i;\n      rcp[i] = T(1);")]
SPLIT_EDITS = {
    "general: no correction": _PRE_TILE_CORRECTION,
    "general: staging loads hit the cache": [
        ("diag[l * blk + (size_t)idx * B + b]", "diag[idx]"),
        ("lower[l * blk + (size_t)idx * B + b]", "lower[blk + idx]"),
        ("upper[l * blk + (size_t)idx * B + b]", "upper[idx]"),
        ("rhs[l * vec + (size_t)i * B + b]", "rhs[i]")],
    "general: no elimination": _PRE_TILE_ELIMINATION,
    "general: no back substitution": [("for (int l = L - 2; l >= 0; --l) {\n    __syncthreads();",
                                       "for (int l = -1; l >= 0; --l) {\n    __syncthreads();")],
    "general: staging, copy-out and back substitution alone": _PRE_TILE_CORRECTION + _PRE_TILE_ELIMINATION,
    "tile: no correction": [("    if (l > 0 && (c < n || rhs_col)) {", "    if (false) {"),
                            ("    if (l > 0) {\n      // P = Low", "    if (false) {\n      // P = Low")],
    "tile: staging loads hit the cache": [
        ("if (tid == nmat * n) return Stager{rhs + vec(l) + b, sR, B, 1};",
         "if (tid == nmat * n) return Stager{rhs, sR, 0, 1};"),
        ("const T* src = (is_low ? lower : is_d ? diag : upper) + blk(l) + (size_t)j * B + b;",
         "const T* src = (is_low ? lower : is_d ? diag : upper) + (size_t)n * n + j;"),
        ("(tid == nmat_next * n ? B : n * B)", "(tid == nmat_next * n ? 0 : n)"),
        ("return Stager{src, sL + j * LS, n * B, 1};", "return Stager{src, sL + j * LS, n, 1};"),
        ("return Stager{src, (is_d ? sD : sU) + j, n * B, LS};", "return Stager{src, (is_d ? sD : sU) + j, n, LS};"),
        ("(c < n ? diag + (size_t)c * B : upper + (size_t)(c - n) * B) + blk(l) + (size_t)i0 * n * B + b;",
         "(c < n ? diag + c : upper + (c - n)) + (size_t)i0 * n;"),
        ("++m, g += (size_t)n * B)", "++m, g += n)")],
    "tile: one elimination step a layer": [
        ("for (int k = 0; k < n; ++k) {\n      T* f = sF", "for (int k = 0; k < 1; ++k) {\n      T* f = sF"),
        ("sW[var[i0 + m] * WS + (c - n)]", "sW[(i0 + m) * WS + (c - n)]"),
        ("sW[var[i] * WS + n] = sH[i] * rcp[i];", "sW[i * WS + n] = sH[i] * rcp[i];"),
        ("      if (next.src) {\n", "      stage(next, 0, k == 0 ? n : 0);\n      if (false) {\n")],
    "tile: no back substitution": [("for (int l = L - 2; l >= 0; --l) {\n    copy_async_wait();",
                                    "for (int l = -1; l >= 0; --l) {\n    copy_async_wait();")],
}


def lane_rel(x, ops):
    """Largest per-lane error of kernel 6's x against the float64 plain
    solve on the same blocks (NaN edge blocks zeroed for it)."""
    torch.cuda.synchronize()
    ref = solve_block_tridiag_lanes(*(o.double().nan_to_num(0.0) for o in ops))
    rel = ((x.double() - ref).abs().amax(dim=(0, 1)) / ref.abs().amax(dim=(0, 1))).max().item()
    return rel if bool(torch.isfinite(x).all()) else float("inf")


def blocktri_rel(ops, **kw):
    return lane_rel(blocktri_wide(*ops, **kw), ops)


def split_copies(bases):
    """(label, text) of each `SPLIT_EDITS` copy of a base's kind; raises if
    an edit's text is not in the base exactly once."""
    copies = []
    for base in bases:
        text = Path(base).read_text()
        body = "tile: " if "blocktri_wide_tile_kernel" in text else "general: "
        for name, edits in SPLIT_EDITS.items():
            if not name.startswith(body):
                continue
            out = text
            for old, new in edits:
                if text.count(old) != 1:
                    raise ValueError(f"--split {base}, {name!r}: {text.count(old)} matches (1 expected) of\n{old}")
                out = out.replace(old, new)
            copies.append((f"{Path(base).name}, {name}", out))
    return copies


def print_ptxas(label, variants):
    """Print ptxas's report (`_build.Build.ptxas`) of a build."""
    for v in variants:
        print(f"  ptxas {label} <{v.args}>: {v.registers} registers, stack {v.stack} B, spill stores "
              f"{v.spill_stores} B, spill loads {v.spill_loads} B, static shared {v.smem} B", flush=True)


def entry_rel(version, ops):
    """`lane_rel` of kernel 6's C entry in ``version`` (another build), its
    outputs allocated here."""
    L, n, _, B = ops[1].shape
    WG = torch.empty((B, L, n, n + 1), dtype=ops[1].dtype, device="cuda")
    x = torch.empty_like(ops[3])
    err = version.entry(ops[1].dtype)(*(t.data_ptr() for t in (*ops, WG, x)), None, L, n, B,
                                      torch.cuda.current_stream().cuda_stream)
    return float("inf") if err else lane_rel(x, ops)


def gradient_operands(nquad=68, nlayers=64):
    """Kernel 6's operands in d sum(flux_up) / d omega of one 64-layer
    NQuad=68 column, flux only, float32 (the column gradient of
    `chip_smoke.py` phase 7: column 0, band 0 of the bench generator): the
    forward solve's and the transposed solve's, as (label, ops)."""
    import pythonic_disort_torch as pt

    from ..models.disort import eval as ev
    from ..ops import cuda_blocktri
    from .check_bvp import bench_arrays

    a = bench_arrays(1, nlayers=nlayers, nquad=nquad, nbands=128)
    kwargs = dict(tau_arr=a["tau"][0], omega_arr=a["omega"][0], NQuad=nquad, Leg_coeffs_all=a["leg"][0],
                  mu0=float(a["mu0"][0]), I0=float(a["I0"][0]), phi0=1.0, f_arr=a["f_arr"][0])
    seen = []
    launch = cuda_blocktri.solve_block_tridiag_lanes_wide

    def record(*ops, **kw):
        seen.append([o.detach().clone(memory_format=torch.contiguous_format) for o in ops])
        return launch(*ops, **kw)

    cuda_blocktri.solve_block_tridiag_lanes_wide = record
    try:
        _, prob = pt.build_problem(**kwargs, only_flux=True, dtype=torch.float32, device="cuda")
        prob.omega_arr = prob.omega_arr.clone().requires_grad_()
        tau = torch.linspace(0.0, float(kwargs["tau_arr"][-1]), 8, dtype=torch.float32, device="cuda")
        torch.autograd.grad(ev.flux_up(pt.solve(prob), tau).sum(), prob.omega_arr)
        torch.cuda.synchronize()
    finally:
        cuda_blocktri.solve_block_tridiag_lanes_wide = launch
    return [(f"NQuad={nquad} column gradient, {what} solve", ops) for what, ops in zip(("forward", "transposed"), seen)]


def jacobi_entry(version, At, sweeps):
    """Kernel 5's C entry point in ``version`` (any build) on ``At``,
    outputs allocated here, the device workspace only where A and V do not
    fit in shared memory; returns a launch function and (w, V)."""
    n, _, B = At.shape
    fn = version.entry(At.dtype)
    w = torch.empty((n, B), dtype=At.dtype, device="cuda")
    V = torch.empty_like(At)
    slots = slot_table(n, At.device)
    nbytes = version.entry(At.dtype, "workspace")(n, B)     # the interface's own workspace query
    ws = torch.empty(nbytes // At.element_size(), dtype=At.dtype, device="cuda") if nbytes else None
    ptrs = [At.data_ptr(), w.data_ptr(), V.data_ptr(), slots.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    wsp = None if ws is None else ws.data_ptr()
    return (lambda: fn(*ptrs, n, B, slots.shape[0], sweeps, wsp, stream)), (w, V)


def time_jacobi_versions(versions, reps=3):
    """Kernel 5's C entry in each `_build.Build` of ``versions`` at the
    shapes of `JACOBI_TIMED`, in turns: versions, then the same in reverse
    order."""
    for label, n, B, dtype in JACOBI_TIMED:
        At = scan_matrices(n, B, 1, dtype)
        times = {}
        for version in versions + versions[::-1]:
            call, _ = jacobi_entry(version, At, default_sweeps(n, dtype))
            if call():
                raise RuntimeError(f"{version.label}: launch failed at n={n} B={B}")
            times.setdefault(version.label, []).append(cuda_ms(call, reps))
        print(f"time jacobi_eigh_wide {label} n={n} B={B} {str(dtype)[6:]} (C entry, ms):", flush=True)
        for name, ts in times.items():
            print(f"    {' '.join(f'{t:.4f}' for t in ts)}  {name}", flush=True)


def time_versions(versions, cases, reps=5):
    """Kernel 6's C entry in each `_build.Build` of ``versions`` on the
    operands of each case (label, ops), in turns: versions, then the same
    in reverse order; outputs allocated once per case."""
    stream = torch.cuda.current_stream().cuda_stream
    for label, ops in cases:
        L, n, _, B = ops[1].shape
        dtype = ops[1].dtype
        WG = torch.empty((B, L, n, n + 1), dtype=dtype, device="cuda")
        x = torch.empty_like(ops[3])
        ptrs = [t.data_ptr() for t in (*ops, WG, x)]
        times = {}
        for version in versions + versions[::-1]:
            fn = version.entry(dtype)
            call = lambda: fn(*ptrs, None, L, n, B, stream)
            if call():
                raise RuntimeError(f"{version.label}: launch failed at L={L} n={n} B={B}")
            times.setdefault(version.label, []).append(cuda_ms(call, reps))
        print(f"time blocktri_wide {label} L={L} n={n} B={B} {str(dtype)[6:]} (C entry, ms):", flush=True)
        for name, ts in times.items():
            print(f"    {' '.join(f'{t:.4f}' for t in ts)}  {name}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build, check and time the wide kernels on one GPU.")
    parser.add_argument("--source", nargs="*", default=[], help="other versions of blocktri_wide.cu to time")
    parser.add_argument("--split", nargs="*", default=[], help="base sources of the SPLIT_EDITS copies")
    parser.add_argument("--jacobi-source", nargs="*", default=[],
                        help="other versions of jacobi_eigh_wide.cu to check and time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_wide: CUDA is not available", file=sys.stderr)
        return 2
    names = ["jacobi_eigh_wide", "blocktri_wide", "blocktri"]
    t0 = time.perf_counter()
    others = [(path, Path(path).read_text()) for path in args.source]
    copies = split_copies(args.split)
    built_all = _build.start(names, [(label, "blocktri_wide", text) for label, text in others + copies]
                             + [(path, "jacobi_eigh_wide", Path(path).read_text()) for path in args.jacobi_source])()
    built, built_jacobi = built_all[:len(others) + len(copies)], built_all[len(others) + len(copies):]
    print(f"built {names} and {len(built_all)} other versions in {time.perf_counter() - t0:.1f} s "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    for version in [*map(_build.current, names[:2]), *built_all]:
        print_ptxas(version.label, version.ptxas())
    failed = 0
    for n, B in JACOBI:
        for dtype in (torch.float32, torch.float64):
            At = scan_matrices(n, B, 10 * n + B, dtype)
            w64 = eigvalsh64(At)
            lim = wide_limits(n, dtype)
            for ws in (False, True):
                w, V = jacobi_wide(At, default_sweeps(n, dtype), workspace=ws)
                label = f"jacobi_wide n={n} B={B} {str(dtype)[6:]}{' workspace' if ws else ''}"
                failed += check_readings(label, readings(At, w, V, w64), dtype, limits=lim)
            for version in built_jacobi:
                call, (w, V) = jacobi_entry(version, At, default_sweeps(n, dtype))
                if call():
                    failed += 1
                    print(f"  {version.label} n={n} B={B}: launch FAILED", flush=True)
                    continue
                label = f"{version.label} n={n} B={B} {str(dtype)[6:]}"
                failed += check_readings(label, readings(At, w, V, w64), dtype, limits=lim)
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

    time_jacobi_versions([_build.current("jacobi_eigh_wide"), *built_jacobi])
    if built_jacobi and not (args.source or args.split):
        print(f"{failed} checks failed")
        return 1 if failed else 0
    ops = random_blocks(64, 68, 256, 1, torch.float32)
    ms = cuda_ms(lambda: blocktri_wide(*ops), 3)
    print(f"  blocktri_wide L=64 n=68 B=256 float32 through solve_block_tridiag_lanes_wide: {ms:.4f} ms", flush=True)
    ops64 = random_blocks(64, 68, 256, 1, torch.float64)
    for version in built[:len(others)]:
        for o in (ops, ops64):
            rel = entry_rel(version, o)
            ok = rel < BT_TOL[o[1].dtype]
            failed += not ok
            print(f"  {version.label} L=64 n=68 B=256 {str(o[1].dtype)[6:]}: per-lane rel {rel:.3e} "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
    del ops64
    cases = itertools.chain(((label, random_blocks(L, n, B, 1, dtype)) for label, L, n, B, dtype in BT_TIMED),
                            gradient_operands())
    time_versions([_build.current("blocktri_wide"), *built], cases)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
