"""Compile-and-check call for ``csrc/eig_stage.cu`` (kernel 1) on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_eig

The short loop after a change to the fused eigen-stage kernel: builds
``eig_stage`` alone, prints what ptxas reports for its six variants
(float32 and float64; rows of 16, 24 and 32 entries for n <= 16, 24 and
32) and, where ``cuobjdump`` is found, each variant's SASS instruction
count; a spill fails the check.  Then it holds the kernel to the float64
plain stage with the order-free readings and limits of ``chip_smoke.py``
(`EIG_TOL`, `eig_errors`, defined here):

- on the main path's At and Bt (n = 16, B = 65 536), captured from
  ``solve_fluxes`` on ``bench.py``'s problem built by
  ``make_batched_problem`` in float64 on the CPU, so that no other kernel
  builds; in float32, and its first 4096 lanes in float64;
- n = 4 at B = 1000 (float32, a 4-stream solve's operands); n = 18, 20,
  22, 24 and 30 at ragged B in float32 and float64;
- the kernel with 3 sweeps on the main-path operands, a control that the
  float32 limits must reject.

It reads the counter ``eig_stage_rows24`` over one traced launch at
n = 24 and one at n = 16 (1 expected).  Then it times the kernel with
CUDA events at `TIMED`: in float32 at n = 16, B = 65 536 (the main
path), n = 16, B = 2048 (the lane count of a 64-layer column with 32
Fourier modes) and n = 24, B = 65 536 (the lanes of an NQuad = 48
chunk), and in float64 at n = 24, B = 322 560 (the ``cloud_radiance``
step's lanes); through its wrapper, and through its C entry point with
outputs allocated once, with its sweeps and with none (the stage around
the Jacobi).  Exits nonzero if a check fails.  ``chip_smoke.py`` at the
repository root is the full run.

    python3 -m pythonic_disort_torch.tools.check_eig --source OTHER.cu ...

also builds each named source (a version of ``eig_stage.cu`` with the same
C interface, e.g. an earlier commit's), prints its ptxas report, holds it
to the same limits on the main-path operands, prints the largest absolute
difference between its outputs and the kernel's at n = 24 in float32 and
float64, and times it beside the kernel in turns (kernel, others,
others, kernel), at the same shapes: through ``eig_stage_lanes`` with
the version launched in place of the tree's (``_build.swapped``), and
through its C entry.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops.cuda_eig import eig_stage_lanes, eig_stage_lanes_plain, jacobi_sweeps
from ..ops.quadrature import double_gauss
from .check_blocktri import cuda_ms
from .check_bvp import bench_problem

# Eigen-stage limits, per reading.  Sorted K and the eigen residual measure
# the Jacobi convergence: on an H100 at the main-path shape (n=16,
# B=65536, f32) the 5-sweep kernel reads 4.1e-7 and 7.9e-8, a 4-sweep
# control the same, a 3-sweep control 1.2e-4 and 1.8e-6.  The float32
# limits sit between the kernel and the 3-sweep control, and the checks
# hold that they reject it.  The Yr, Pr V = I and Qr Yr = I readings
# hold for any orthogonal Z and measure roundoff alone: float32 unit
# roundoff 6e-8 grown by the conditioning of -Bt (its 1/mu diagonal spans
# ~200x at NQuad=32); float64 the same growth on 1.1e-16.
EIG_TOL = {
    "float32": dict(k_rel=5e-6, r_eig=5e-7, r_y=1e-4, r_p=1e-4, r_q=1e-4),
    "float64": dict(k_rel=1e-10, r_eig=1e-10, r_y=1e-10, r_p=1e-9, r_q=1e-9),
}
EIG_READINGS = {
    "k_rel": "sorted K, relative to the lane's largest K,",
    "r_eig": "eigen residual |At Bt V - V K^2|",
    "r_y": "Yr residual |Yr - Bt V/K|",
    "r_p": "|Pr V - I|",
    "r_q": "|Qr Yr - I|",
}
# the shapes timed: (label, n, B, dtype)
TIMED = [("main path", 16, 65536, torch.float32), ("column", 16, 2048, torch.float32),
         ("NQuad=48 chunk", 24, 65536, torch.float32), ("cloud step", 24, 322560, torch.float64)]
# the ragged widths checked in both dtypes: (n, B) with B not a multiple of a block's lanes
RAGGED = [(18, 1001), (20, 777), (22, 1503), (24, 2999), (30, 501)]

# cuobjdump -sass: a function header, and one instruction line
_SASS_FUNC = re.compile(r"Function : \S*?kernelI(\w+?)Ev")
_SASS_INSN = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S")


def plain_K(At, Bt):
    """K of the plain stage (Cholesky and the plain two-sided Jacobi) in
    float64, on At's device."""
    return eig_stage_lanes_plain(At.double(), Bt.double())[0]


def eig_errors(At, Bt, outs, Kp):
    """Order-free errors of eigen-stage outputs ``outs`` = (K, V, Yr, Pr, Qr)
    against the float64 plain K ``Kp``, each the largest over the lanes."""
    K, V, Yr, Pr, Qr = outs
    A64, B64 = At.double().permute(2, 0, 1), Bt.double().permute(2, 0, 1)
    p = lambda x: x.double().permute(2, 0, 1)               # (B, n, n)
    K64, V64, Y64, P64, Q64 = K.double().T, p(V), p(Yr), p(Pr), p(Qr)
    eye = torch.eye(At.shape[0], dtype=torch.float64, device=At.device)
    ks, kp = K64.sort(dim=1).values, Kp.T.sort(dim=1).values
    k_abs = (ks - kp).abs()
    # residuals, each relative to the size of the terms it balances
    AB = A64 @ B64
    return dict(
        k_abs=k_abs.max().item(),
        k_rel=(k_abs / kp.amax(dim=1, keepdim=True)).max().item(),
        r_eig=((AB @ V64 - V64 * K64[:, None, :] ** 2).abs().amax(dim=(1, 2))
               / (AB.abs().amax(dim=(1, 2)) * V64.abs().amax(dim=(1, 2)))).max().item(),
        r_y=((Y64 - B64 @ V64 / K64[:, None, :]).abs().amax(dim=(1, 2))
             / Y64.abs().amax(dim=(1, 2))).max().item(),
        r_p=(P64 @ V64 - eye).abs().max().item(),
        r_q=(Q64 @ Y64 - eye).abs().max().item(),
    )


def beyond_limits(e, dtype):
    """The readings of `EIG_READINGS` that exceed their `EIG_TOL` limit."""
    tol = EIG_TOL[str(dtype).removeprefix("torch.")]
    return [k for k in EIG_READINGS if not e[k] < tol[k]]


def run_sweeps(At, Bt, sweeps, version=None):
    """The kernel with ``sweeps`` Jacobi sweeps instead of its fixed count,
    called through its C entry point (not counted as a launch) of the
    tree's build, or of ``version``, another `_build.Build`.  Returns the
    entry's error code and (K, V, Yr, Pr, Qr)."""
    n, _, B = At.shape
    outs = (torch.empty((n, B), dtype=At.dtype, device=At.device),
            *(torch.empty_like(At) for _ in range(4)))
    err = (version or _build.current("eig_stage")).entry(At.dtype)(
        At.data_ptr(), Bt.data_ptr(), *(x.data_ptr() for x in outs), n, B, sweeps,
        torch.cuda.current_stream(At.device).cuda_stream)
    torch.cuda.synchronize()
    return err, outs


def function_operands(n, B, seed, dtype, device):
    """At, Bt (n, n, B) of the eigen stage for one Fourier mode of random
    Henyey-Greenstein layers (albedo 0.2-0.99): the operands a solve at
    NQuad = 2n builds, for widths the bench configuration does not reach."""
    rng = np.random.default_rng(seed)
    mu, w = double_gauss(2 * n)
    ell = np.arange(2 * n)
    coef = (rng.uniform(0.2, 0.99, B)[:, None] / 2) * (2 * ell + 1) \
        * rng.uniform(0.0, 0.9, B)[:, None] ** ell
    P = np.polynomial.legendre.legvander(mu, 2 * n - 1)
    Dp = np.einsum("il,jl,bl->ijb", P, P, coef)
    Dm = np.einsum("il,jl,bl->ijb", P, P * (-1.0) ** ell, coef)
    rho = np.sqrt(w / mu)
    outer = rho[:, None, None] * rho[None, :, None]
    inv_mu = np.diag(1 / mu)[:, :, None]
    t = lambda x: torch.tensor(x, dtype=dtype, device=device).contiguous()
    return t(outer * (Dp - Dm) - inv_mu), t(outer * (Dp + Dm) - inv_mu)


class _Captured(Exception):
    pass


def captured_operands(ncols, nlayers, nquad, seed):
    """The At, Bt that ``solve_fluxes`` hands the eigen stage on a
    `check_bvp.bench_problem`, in float64 on the CPU; the solve stops
    there, so no kernel builds."""
    import pythonic_disort_torch as pt
    from ..ops import eig as eig_mod

    prob = bench_problem(ncols, nlayers, nquad, seed)
    seen = []

    def record(At, Bt):
        seen.append((At.clone(), Bt.clone()))
        raise _Captured

    wrapper, eig_mod.eig_stage_lanes = eig_mod.eig_stage_lanes, record
    try:
        pt.solve_fluxes(prob, prob.tau_arr)
    except _Captured:
        pass
    finally:
        eig_mod.eig_stage_lanes = wrapper
    return seen[-1]


def _cuobjdump():
    """Path of cuobjdump: on PATH, in the CUDA toolkit, or in Triton's
    package; None where none is found."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    if Path("/usr/local/cuda/bin/cuobjdump").exists():
        return "/usr/local/cuda/bin/cuobjdump"
    try:
        import triton
    except ImportError:
        return None
    path = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    return str(path) if path.exists() else None


def sass_counts(name):
    """{template arguments: SASS instruction count} of every kernel variant
    in ``csrc/<name>.cu``'s library, or None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        return None
    counts, current = {}, None
    for line in out.stdout.splitlines():
        head = _SASS_FUNC.search(line)
        if head:
            current = head.group(1)
            counts[current] = 0
        elif current is not None and _SASS_INSN.match(line):
            counts[current] += 1
    return counts


def report_build():
    """Print ptxas's report and the SASS counts of every variant; returns
    the bytes spilled over all of them."""
    variants = _build.current("eig_stage").ptxas()
    sass = sass_counts("eig_stage")
    for v in variants:
        count = "not available" if sass is None else sass.get(v.args, "not found")
        print(f"ptxas eig_stage<{v.args}>: {v.registers} registers, stack {v.stack} B, spill stores "
              f"{v.spill_stores} B, spill loads {v.spill_loads} B, static shared {v.smem} B; SASS instructions "
              f"{count}", flush=True)
    return sum(v.spill_stores + v.spill_loads for v in variants)


def rows24_count(a24, b24, a16, b16):
    """The counter ``eig_stage_rows24`` over one launch at n = 24 and one
    at n = 16, under a profiler (the recorder's gate)."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        eig_stage_lanes(a24, b24)
        eig_stage_lanes(a16, b16)
        torch.cuda.synchronize()
    return profiling.recorded()["counters"].get("eig_stage_rows24", 0)


def max_differences(At, Bt, version):
    """Largest absolute difference of each output (K, V, Yr, Pr, Qr) of
    ``version`` (another build) from the kernel's, on At, Bt, and whether
    all outputs are the same bits."""
    _, mine = run_sweeps(At, Bt, jacobi_sweeps(At.dtype))
    _, theirs = run_sweeps(At, Bt, jacobi_sweeps(At.dtype), version)
    bits = torch.int32 if At.dtype == torch.float32 else torch.int64
    same = all(torch.equal(a.view(bits), b.view(bits)) for a, b in zip(mine, theirs))
    return [(a.double() - b.double()).abs().max().item() for a, b in zip(mine, theirs)], same


def check_case(label, At, Bt, Kp=None):
    """The kernel against the float64 plain stage; True if within limits."""
    outs = eig_stage_lanes(At, Bt)
    torch.cuda.synchronize()
    Kp = plain_K(At, Bt) if Kp is None else Kp
    finite = all(bool(torch.isfinite(x).all()) for x in outs)
    e = eig_errors(At, Bt, outs, Kp)
    bad = beyond_limits(e, At.dtype) + ([] if finite else ["finite"])
    print(f"{label}: sorted K rel {e['k_rel']:.3e}, |At Bt V - V K^2| {e['r_eig']:.3e}, "
          f"|Yr - Bt V/K| {e['r_y']:.3e}, |Pr V - I| {e['r_p']:.3e}, |Qr Yr - I| {e['r_q']:.3e} "
          f"{'ok' if not bad else 'FAILED ' + ','.join(bad)}", flush=True)
    return not bad


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build, check and time csrc/eig_stage.cu on one GPU.")
    parser.add_argument("--source", nargs="*", default=[], help="other versions of eig_stage.cu to time beside it")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_eig: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    others = _build.start(["eig_stage"], [(path, "eig_stage", Path(path).read_text()) for path in args.source])()
    print(f"built eig_stage and {len(others)} other versions in {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    failed = 0
    spilled = report_build()
    failed += spilled > 0
    if spilled:
        print(f"FAILED: eig_stage spills {spilled} B", flush=True)
    f32, f64 = torch.float32, torch.float64
    A64, B64 = captured_operands(8, 64, 32, 42)
    At, Bt = A64.to("cuda", f32).contiguous(), B64.to("cuda", f32).contiguous()
    Kp = plain_K(At, Bt)
    failed += not check_case(f"main path n=16 B={At.shape[2]} f32", At, Bt, Kp)
    failed += not check_case("main path n=16 B=4096 f64",
                             A64[..., :4096].to("cuda").contiguous(), B64[..., :4096].to("cuda").contiguous())
    small = captured_operands(1, 10, 8, 5)
    failed += not check_case("n=4 B=1000 f32 (ragged)", *(x[..., :1000].to("cuda", f32).contiguous() for x in small))
    for n, B in RAGGED:
        for dtype in (f32, f64):
            name = str(dtype).removeprefix("torch.float")
            failed += not check_case(f"n={n} B={B} f{name} (ragged)", *function_operands(n, B, n + B, dtype, "cuda"))
    sweeps = jacobi_sweeps(f32) - 2
    err, outs = run_sweeps(At, Bt, sweeps)
    e = eig_errors(At, Bt, outs, Kp)
    rejected = err == 0 and bool(beyond_limits(e, f32))
    failed += not rejected
    print(f"control, {sweeps} sweeps: sorted K rel {e['k_rel']:.3e}, |At Bt V - V K^2| {e['r_eig']:.3e}; "
          f"{'rejected by the float32 limits: ok' if rejected else 'FAILED: not rejected'}", flush=True)

    # n = 24 operands: 65 536 lanes, and those lanes repeated to the cloud step's 322 560 in float64
    wide64 = function_operands(24, 65536, 10, f64, "cuda")
    wide = tuple(x.float().contiguous() for x in wide64)
    cloud = tuple(x.repeat(1, 1, 5)[..., :322560].contiguous() for x in wide64)
    ops = {(16, f32): (At, Bt), (24, f32): wide, (24, f64): cloud}
    rows24 = rows24_count(*wide, At[..., :2048].contiguous(), Bt[..., :2048].contiguous())
    failed += rows24 != 1
    print(f"counter eig_stage_rows24 over a traced launch at n=24 and one at n=16: {rows24} "
          f"{'ok' if rows24 == 1 else 'FAILED (1 expected)'}", flush=True)
    versions = [_build.current("eig_stage")]
    for other in others:
        for v in other.ptxas():
            print(f"ptxas {other.label}<{v.args}>: {v.registers} registers, stack {v.stack} B, spill stores "
                  f"{v.spill_stores} B, spill loads {v.spill_loads} B", flush=True)
        err, outs = run_sweeps(At, Bt, jacobi_sweeps(f32), other)
        bad = ["launch"] if err else beyond_limits(eig_errors(At, Bt, outs, Kp), f32)
        failed += bool(bad)
        print(f"{other.label}: main path n=16 B={At.shape[2]} f32 {'ok' if not bad else 'FAILED ' + ','.join(bad)}",
              flush=True)
        for dtype, (a, b) in ((f32, wide), (f64, tuple(x[..., :65536] for x in wide64))):
            diffs, same = max_differences(a, b, other)
            print(f"{other.label}: n=24 B=65536 {str(dtype).removeprefix('torch.')}, largest |difference| from "
                  f"eig_stage.cu in K, V, Yr, Pr, Qr: {' '.join(f'{d:.3e}' for d in diffs)}; "
                  f"{'the same bits' if same else 'not the same bits'}", flush=True)
        versions.append(other)
    stream = torch.cuda.current_stream().cuda_stream
    for label, n, B, dtype in TIMED:
        a, b = (x[..., :B].contiguous() for x in ops[n, dtype])
        outs = (torch.empty((n, B), dtype=dtype, device="cuda"), *(torch.empty_like(a) for _ in range(4)))
        ptrs = [x.data_ptr() for x in (a, b, *outs)]
        entry = lambda fn, sw: (lambda: fn(*ptrs, n, B, sw, stream))
        reps = 20 if B <= 65536 else 5
        wrapped, times, bare = {}, {}, {}
        for version in versions + versions[::-1]:
            fn = version.entry(dtype)
            with _build.swapped(version):
                wrapped.setdefault(version.label, []).append(cuda_ms(lambda: eig_stage_lanes(a, b), reps))
            times.setdefault(version.label, []).append(cuda_ms(entry(fn, jacobi_sweeps(dtype)), reps))
            bare.setdefault(version.label, []).append(cuda_ms(entry(fn, 0), reps))
        show = lambda d: "; ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms" for name, ts in d.items())
        print(f"time {label} n={n} B={B} {str(dtype).removeprefix('torch.')}: through eig_stage_lanes: "
              f"{show(wrapped)}; C entry: {show(times)}", flush=True)
        print(f"  the same without the sweeps (the stage around the Jacobi): {show(bare)}", flush=True)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
