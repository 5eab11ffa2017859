"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pythonic_disort_torch/csrc``, holds
each kernel against its plain PyTorch version on inputs taken from a real
main-path solve, drives the main path (the batched flux-only sweep of
``bench.py``: 64 layers, NQuad=32, 128 bands per column, 8-column chunks,
delta-M beam, float32) through ``make_batched_problem`` and
``solve_fluxes``, checks it against the port's float64 CPU result, and
times it.  Every failed check raises, so the exit code is nonzero.

Its last two lines are a JSON line of per-kernel numbers and
``{"ok": true, "device": {...}}``.  Without CUDA it exits nonzero and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np

NBANDS, NLAYERS, NQUAD = 128, 64, 32
CHUNK_COLS, REF_COLS, N_CHUNKS, REPS = 8, 2, 8, 3
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and float32 /
# float64 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "float64": 34e12}
# cuSOLVER's batched eigh (behind torch.linalg.eigh on the card) refuses
# 32768 or more 16x16 matrices in one call (CUSOLVER_STATUS_INVALID_VALUE
# with torch 2.11 / CUDA 12.8), so the plain eigen stage and the library
# yardstick are timed in lane chunks.
EIGH_CHUNK = 16384
# Eigen-stage limits, per reading.  Sorted K and the eigen residual measure
# the Jacobi convergence: on an H100 at the main-path shape (n=16,
# B=65536, f32) the 5-sweep kernel reads 4.1e-7 and 7.9e-8, a 4-sweep
# control the same, a 3-sweep control 1.2e-4 and 1.8e-6.  The float32
# limits sit between the kernel and the 3-sweep control, and phase 3
# checks that they reject it.  The Yr, Pr V = I and Qr Yr = I readings
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


def log(*a):
    print(*a, flush=True)


class CheckFailed(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)
    log(f"  ok: {what}")


# ----------------------------------------------------------------- inputs
def bench_arrays(ncols, seed=42, nlayers=NLAYERS, nquad=NQUAD):
    """The generator of bench.py:51-77 (same seed, same draws)."""
    rng = np.random.default_rng(seed)
    B = ncols * NBANDS
    nleg_all = nquad + 1
    thickness = rng.uniform(0.05, 0.5, (B, nlayers))
    tau = np.cumsum(thickness, axis=1)
    omega = rng.uniform(0.3, 0.99, (B, nlayers))
    g = rng.uniform(0.5, 0.85, (B, nlayers))
    leg = g[..., None] ** np.arange(nleg_all)[None, None, :]
    return dict(tau=tau, omega=omega, leg=leg, f_arr=leg[..., nquad],
                mu0=rng.uniform(0.2, 1.0, B), I0=np.full(B, np.pi))


def make_problem(arrs, dtype, device, nquad=NQUAD):
    import pythonic_disort_torch as pt

    nlayers = arrs["tau"].shape[1]
    cfg = pt.DisortConfig(
        nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=1, nlayers=nlayers,
        nscoeffs=0, nbdrf=0, has_beam=True, only_flux=True, has_deltam=True)
    prob = pt.make_batched_problem(
        cfg, arrs["tau"], arrs["omega"], arrs["leg"], arrs["mu0"], arrs["I0"],
        f_arr=arrs["f_arr"], dtype=dtype, device=device)
    # fluxes at the layer bottoms, with tau already on the device
    return prob, prob.tau_arr


def rows(arrs, n):
    return {k: v[:n] for k, v in arrs.items()}


def phase_function_operands(n, B, seed, dtype, device):
    """At, Bt (n, n, B) of the eigen stage for one Fourier mode of random
    Henyey-Greenstein layers (albedo 0.2-0.99): the operands a solve at
    NQuad = 2n builds, for widths the bench configuration does not reach."""
    import torch
    from pythonic_disort_torch.ops.quadrature import double_gauss

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


def capture_kernel_inputs(problem, tau):
    """Run the main path once, keeping copies of both kernels' operands."""
    from pythonic_disort_torch import solve_fluxes
    from pythonic_disort_torch.models.disort import batch_solve as bs_mod
    from pythonic_disort_torch.ops import eig as eig_mod

    got = {}
    orig_eig, orig_bvp = eig_mod.eig_stage_lanes, bs_mod.solve_bvp_fused

    def rec_eig(At, Bt):
        got["eig"] = (At.clone(), Bt.clone())
        return orig_eig(At, Bt)

    def rec_bvp(*ops):
        got["bvp"] = tuple(x.clone() for x in ops)
        return orig_bvp(*ops)

    eig_mod.eig_stage_lanes, bs_mod.solve_bvp_fused = rec_eig, rec_bvp
    try:
        solve_fluxes(problem, tau)
    finally:
        eig_mod.eig_stage_lanes, bs_mod.solve_bvp_fused = orig_eig, orig_bvp
    return got


# ----------------------------------------------------------------- timing
def in_chunks(fn, *lanes_ops, chunk=EIGH_CHUNK):
    """Call ``fn`` on consecutive lane chunks (the batch is the last axis)."""
    B = lanes_ops[0].shape[-1]
    for b in range(0, B, chunk):
        fn(*(x[..., b:b + chunk] for x in lanes_ops))


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOP_S[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def eig_flops(n, sweeps):
    """Operations the eigen stage needs per lane: two Cholesky
    factorizations (n^3/3 each), the congruence M = L^T (-At) L (two
    triangular products, 2n^3), the Jacobi sweeps (n - 1 rounds of n/2
    pairs; a pair takes one 2n dot and the rotation of its two rows of C
    and of Z, 12n: 7n^2(n - 1) per sweep) and the back-transforms
    V = L^-T Z and L Z (2n^3) with the scalings by K (2n^2)."""
    chol = 2 * n**3 / 3
    congruence = 2 * n**3
    jacobi = 7 * n * n * (n - 1) * sweeps
    back = 2 * n**3 + 2 * n * n
    return chol + congruence + jacobi + back


def bvp_flops(L, N):
    """Operations of the BVP solve per lane, as the kernel does them: the
    layer correction Low H u (L-1 layers), the Gauss-Jordan elimination of
    the 2N x (3N+1) system (L layers) and the back substitution."""
    corr = 2 * N * (2 * N * (N + 1) + 2 * N * N)
    gj = 4 * N * (4 * N * N + 3 * N)
    back = 8 * N * N
    return (L - 1) * corr + L * gj + (L - 1) * back


# ------------------------------------------------------------ eigen checks
def plain_K(At, Bt):
    """K of the plain stage in float64 on the CPU (cuSOLVER's batched eigh
    refuses the main path's lane count), on At's device."""
    from pythonic_disort_torch.ops.cuda_eig import eig_stage_lanes_plain

    return eig_stage_lanes_plain(At.double().cpu(), Bt.double().cpu())[0].to(At.device)


def eig_errors(At, Bt, outs, Kp):
    """Order-free errors of eigen-stage outputs ``outs`` = (K, V, Yr, Pr, Qr)
    against the float64 plain K ``Kp``, each the largest over the lanes."""
    import torch

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


def log_eig_errors(label, e):
    log(f"  {label}: sorted K rel {e['k_rel']:.3e}, |At Bt V - V K^2| {e['r_eig']:.3e}, "
        f"|Yr - Bt V/K| {e['r_y']:.3e}, |Pr V - I| {e['r_p']:.3e}, |Qr Yr - I| {e['r_q']:.3e}")


def eig_sweep_control(At, Bt, Kp, sweeps):
    """The eigen kernel with fewer Jacobi sweeps than its fixed count,
    called through its C entry point (not counted as a launch): a control
    for the limits of `EIG_TOL`."""
    import torch
    from pythonic_disort_torch.ops import cuda_eig

    n, _, B = At.shape
    outs = (torch.empty((n, B), dtype=At.dtype, device=At.device),
            *(torch.empty_like(At) for _ in range(4)))
    err = cuda_eig._kernel(At.dtype)(
        At.data_ptr(), Bt.data_ptr(), *(x.data_ptr() for x in outs), n, B, sweeps,
        torch.cuda.current_stream(At.device).cuda_stream)
    torch.cuda.synchronize()
    check(err == 0, f"{sweeps}-sweep control launched")
    e = eig_errors(At, Bt, outs, Kp)
    log_eig_errors(f"control, {sweeps} sweeps", e)
    return e


def eig_checks(At, Bt, label, full=False, Kp=None):
    """Kernel vs plain, order-free; returns (max_abs_err, max_rel_err)."""
    import torch
    from pythonic_disort_torch.ops.cuda_eig import eig_stage_lanes

    outs = eig_stage_lanes(At, Bt)
    torch.cuda.synchronize()
    Kp = plain_K(At, Bt) if Kp is None else Kp
    check(all(torch.isfinite(x).all() for x in outs), f"{label}: outputs finite")
    e = eig_errors(At, Bt, outs, Kp)
    log_eig_errors(label, e)
    tol = EIG_TOL[str(At.dtype).removeprefix("torch.")]
    for k, what in EIG_READINGS.items():
        check(e[k] < tol[k], f"{label}: {what} < {tol[k]:g}")
    if full:
        eye = torch.eye(At.shape[0], dtype=torch.float64, device=At.device)
        V64, B64 = outs[1].double().permute(2, 0, 1), Bt.double().permute(2, 0, 1)
        # per-lane orthogonality of Z = L^T V (tests_tpu bound 1e-4)
        Lc = torch.linalg.cholesky(-B64)
        Z = Lc.transpose(-1, -2) @ V64
        orth = (Z.transpose(-1, -2) @ Z - eye).abs().amax(dim=(1, 2))
        log(f"  {label}: per-lane max |Z^T Z - I| = {orth.max().item():.3e}")
        check(orth.max().item() < 1e-4, f"{label}: per-lane orthogonality < 1e-4 at B={At.shape[2]}")
    return e["k_abs"], e["k_rel"]


def bvp_checks(ops, label):
    """Kernel vs the plain version in float64 on the same inputs."""
    import torch
    from pythonic_disort_torch.ops.cuda_blocktri import solve_bvp_fused, solve_bvp_fused_plain

    x = solve_bvp_fused(*ops)
    torch.cuda.synchronize()
    xp = solve_bvp_fused_plain(*(o.double() for o in ops))
    err = (x.double() - xp).abs()
    lane_scale = xp.abs().amax(dim=(0, 1))
    rel = (err.amax(dim=(0, 1)) / lane_scale).max().item()
    log(f"  {label}: max |x - x64| {err.max().item():.3e}, per-lane rel {rel:.3e}")
    check(torch.isfinite(x).all().item(), f"{label}: x finite")
    # f32 roundoff grown by the conditioning of the pivoted block
    # elimination; f64 runs hold the kernel to its own precision
    tol = 1e-3 if x.dtype == torch.float32 else 1e-9
    check(rel < tol, f"{label}: x within {tol:g} of the float64 plain solve (per lane)")
    return err.max().item(), rel


# ------------------------------------------------------------------ phases
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from pythonic_disort_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(_build.kernel_sources())
    log(f"built {_build.kernel_sources()} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(main_ops):
    import torch
    from pythonic_disort_torch.ops.cuda_blocktri import solve_bvp_fused, solve_bvp_fused_plain
    from pythonic_disort_torch.ops.cuda_eig import (
        eig_stage_lanes, eig_stage_lanes_plain, jacobi_sweeps)

    log("phase 3: kernels against their plain versions")
    At, Bt = main_ops["eig"]
    Kp = plain_K(At, Bt)
    eig_abs, eig_rel = eig_checks(At, Bt, f"eig n={At.shape[0]} B={At.shape[2]} f32", full=True, Kp=Kp)
    # controls: the kernel one and two sweeps short of its fixed count
    sweeps, tol = jacobi_sweeps(At.dtype), EIG_TOL["float32"]
    eig_sweep_control(At, Bt, Kp, sweeps - 1)
    short = eig_sweep_control(At, Bt, Kp, sweeps - 2)
    check(short["k_rel"] >= tol["k_rel"] or short["r_eig"] >= tol["r_eig"],
          f"the float32 limits reject the {sweeps - 2}-sweep control")
    small = capture_kernel_inputs(*make_problem(
        bench_arrays(1, seed=5, nlayers=10, nquad=8), torch.float32, "cuda", nquad=8))
    eig_checks(*(x[..., :1000].contiguous() for x in small["eig"]), "eig n=4 B=1000 f32 (ragged)")
    eig_checks(At[..., :4096].double().contiguous(), Bt[..., :4096].double().contiguous(), "eig n=16 B=4096 f64")
    # the 32-thread-per-matrix variant (16 < n <= 32), NQuad = 48
    eig_checks(*phase_function_operands(24, 3000, 8, torch.float32, "cuda"), "eig n=24 B=3000 f32 (ragged)")
    eig_checks(*phase_function_operands(24, 500, 9, torch.float64, "cuda"), "eig n=24 B=500 f64 (ragged)")

    ops = main_ops["bvp"]
    bvp_abs, bvp_rel = bvp_checks(ops, f"bvp L={ops[0].shape[0]} 2N={ops[0].shape[1]} B={ops[0].shape[3]} f32")
    one = capture_kernel_inputs(*make_problem(bench_arrays(7, seed=6, nlayers=1), torch.float32, "cuda"))
    bvp_checks(tuple(o[..., :777].contiguous() for o in one["bvp"]), "bvp L=1 B=777 f32 (ragged)")
    five = capture_kernel_inputs(*make_problem(bench_arrays(8, seed=7, nlayers=5), torch.float64, "cuda"))
    bvp_checks(tuple(o[..., :1001].contiguous() for o in five["bvp"]), "bvp L=5 B=1001 f64 (ragged)")

    log("timing kernels at the main-path shapes (CUDA events)")
    n, B = At.shape[0], At.shape[2]
    eig_ms = cuda_ms(lambda: eig_stage_lanes(At, Bt), 20)
    eig_plain_ms = cuda_ms(lambda: in_chunks(eig_stage_lanes_plain, At, Bt), 3)
    Lc = torch.linalg.cholesky(-Bt.permute(2, 0, 1))
    M = (Lc.transpose(-1, -2) @ (-At.permute(2, 0, 1)) @ Lc).permute(1, 2, 0)
    eigh_ms = cuda_ms(lambda: in_chunks(lambda m: torch.linalg.eigh(m.permute(2, 0, 1)), M), 3)
    esz = At.element_size()
    eig_bound, eig_by = bound_ms((2 * n * n + 4 * n * n + n) * B * esz,
                                 eig_flops(n, jacobi_sweeps(At.dtype)) * B, "float32")
    L, n2, _, Bb = ops[0].shape
    bvp_ms = cuda_ms(lambda: solve_bvp_fused(*ops), 20)
    bvp_plain_ms = cuda_ms(lambda: solve_bvp_fused_plain(*ops), 2)
    bvp_bytes = sum(o.numel() for o in ops) * esz + ops[3].numel() * esz
    bvp_bound, bvp_by = bound_ms(bvp_bytes, bvp_flops(L, n2 // 2) * Bb, "float32")
    log(f"  eig_stage: {eig_ms:.4f} ms (plain {eig_plain_ms:.3f} ms, torch.linalg.eigh on M "
        f"{eigh_ms:.3f} ms, bound {eig_bound:.4f} ms by {eig_by})")
    log(f"  bvp_fused: {bvp_ms:.4f} ms (plain {bvp_plain_ms:.3f} ms, bound {bvp_bound:.4f} ms by {bvp_by})")
    return [
        dict(name="eig_stage", route="cuda", source="pythonic_disort_torch/csrc/eig_stage.cu",
             replaces="pythonic_disort_tpu/ops/pallas_eig.py:172",
             replaces_function="eig_stage_lanes_pallas",
             launches=None, max_abs_err=eig_abs, max_err=eig_rel, ms=eig_ms, plain_ms=eig_plain_ms,
             bound_ms=eig_bound, bound_by=eig_by, library_ms=eigh_ms,
             library_call=f"torch.linalg.eigh on the (B, 16, 16) M matrices in chunks of {EIGH_CHUNK} (eigh alone, not the stage)"),
        dict(name="bvp_fused", route="cuda", source="pythonic_disort_torch/csrc/bvp_fused.cu",
             replaces="pythonic_disort_tpu/ops/pallas_blocktri.py:382",
             replaces_function="solve_bvp_fused_pallas",
             launches=None, max_abs_err=bvp_abs, max_err=bvp_rel, ms=bvp_ms, plain_ms=bvp_plain_ms,
             bound_ms=bvp_bound, bound_by=bvp_by, library_ms=None, library_call=None),
    ]


def phase_main_path(arrs, problem, tau, kernels):
    import torch
    from pythonic_disort_torch import solve_fluxes
    from pythonic_disort_torch.ops.cuda_blocktri import solve_bvp_fused
    from pythonic_disort_torch.ops.cuda_eig import eig_stage_lanes

    log(f"phase 4: main path, {CHUNK_COLS} columns x {NBANDS} bands, L={NLAYERS}, NQuad={NQUAD}, f32, cuda")
    eig_stage_lanes.launches = 0
    solve_bvp_fused.launches = 0
    out = solve_fluxes(problem, tau)
    torch.cuda.synchronize()
    launches = {"eig_stage": eig_stage_lanes.launches, "bvp_fused": solve_bvp_fused.launches}
    log(f"  launches in one chunk: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    check(all(v > 0 for v in launches.values()), "both kernels launched on the main path")
    check(all(torch.isfinite(x).all().item() for x in out), "fluxes finite")
    check(all(x.shape == (CHUNK_COLS * NBANDS, NLAYERS) for x in out), "fluxes have shape (1024, 64)")

    nref = REF_COLS * NBANDS
    t0 = time.perf_counter()
    p64, tau64 = make_problem(rows(arrs, nref), torch.float64, "cpu")
    ref = [x.numpy() for x in solve_fluxes(p64, tau64)]
    log(f"  float64 CPU reference ({nref} solves) in {time.perf_counter() - t0:.1f} s")
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref, out):
        b = b[:nref].double().cpu().numpy()
        scale = max(np.abs(a).max(), 1.0)
        d = np.abs(a - b).max()
        log(f"  {lbl}: max |f32 - f64| = {d:.3e} (bound {1e-3 * scale:.3e})")
        check(d < 1e-3 * scale, f"{lbl} within 1e-3 x max(|f|, 1) of float64")

    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CHUNKS):
            solve_fluxes(problem, tau)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    chunk_ms = 1e3 * best / N_CHUNKS
    eig_ms = kernels[0]["ms"] * launches["eig_stage"]
    bvp_ms = kernels[1]["ms"] * launches["bvp_fused"]
    cols_s = N_CHUNKS * CHUNK_COLS / best
    log(f"  steady state: {cols_s:.3f} columns/s ({N_CHUNKS} chunks best of {REPS}: "
        f"{1e3 * best:.2f} ms); per chunk {chunk_ms:.3f} ms = eig kernel {eig_ms:.3f} + "
        f"BVP kernel {bvp_ms:.3f} + rest {chunk_ms - eig_ms - bvp_ms:.3f} ms")
    return chunk_ms


def phase_trace(problem, tau, chunk_ms):
    """One main-path chunk under torch.profiler: the card's busy time (the
    union of its kernel and copy intervals), its idle share against the
    untraced chunk time, the device work by name, and the host's CUDA
    runtime calls (launches, copies, synchronizations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pythonic_disort_torch import solve_fluxes

    log("phase 4, traced: one chunk under torch.profiler")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_fluxes(problem, tau)
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        log("  the profiler saw no device activity: busy time and idle share not measured")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    window_us = max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
    per_name = Counter()
    calls = Counter(e.name for e in dev)
    for e in dev:
        per_name[e.name] += e.time_range.elapsed_us()
    busy_ms = busy_us / 1e3
    log(f"  device busy {busy_ms:.3f} ms in {len(dev)} device operations "
        f"(first start to last end {window_us / 1e3:.3f} ms); idle share against the "
        f"untraced chunk ({chunk_ms:.3f} ms): {1 - busy_ms / chunk_ms:.3f}")
    for name, us in per_name.most_common(12):
        log(f"    {us / 1e3:8.3f} ms  x{calls[name]:<4d} {name[:90]}")
    copies = {k: v for k, v in calls.items() if k.startswith(("Memcpy", "Memset"))}
    log(f"  device copies and sets: {copies or 'none'}")
    runtime = Counter(e.name for e in events
                      if e.device_type == DeviceType.CPU and e.name.startswith(("cuda", "cuLaunch", "cuMemcpy")))
    log("  host CUDA runtime calls: " + ", ".join(f"{k} x{v}" for k, v in sorted(runtime.items())))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import pythonic_disort_torch  # noqa: F401  (fails outside the repository)

    log("phase 1: device")
    phase_device()
    log("phase 2: build")
    phase_build()
    arrs = bench_arrays(CHUNK_COLS)
    problem, tau = make_problem(arrs, torch.float32, "cuda")
    main_ops = capture_kernel_inputs(problem, tau)
    kernels = phase_kernels(main_ops)
    chunk_ms = phase_main_path(arrs, problem, tau, kernels)
    phase_trace(problem, tau, chunk_ms)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
