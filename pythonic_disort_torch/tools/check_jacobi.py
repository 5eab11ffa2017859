"""Compile-and-check call and A/B loop for ``csrc/jacobi_eigh.cu`` (kernel
4) on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_jacobi [--source OTHER.cu ...]

The short loop after a change to the kernel: builds that source (and
``jacobi_eigh_wide.cu``, kernel 5, the yardstick) and every ``--source``
file (another version of ``jacobi_eigh.cu`` with the same C interface,
e.g. an earlier commit's via ``git show <rev>:pythonic_disort_torch/csrc/
jacobi_eigh.cu > build/old_jacobi.cu``, or an edited copy under
``build/``), one nvcc each, all started together, and prints each
version's ptxas registers and spills.  It holds every version, through
its C entry, to `LIMITS` against the float64 eigenvalues and to per-lane
orthogonality and reconstruction bounds at the shapes of `CHECKED` in
float32 and float64, on batches whose diagonals tie exactly, in pairs or
all alike (a tied pair turns by 45 degrees), and on the 131072-lane
reconstruction scan of the TPU kernel's regression test.  Then it times
all versions in turns (versions, then the same reversed), with kernel 5
and ``torch.linalg.eigh`` (the library call, in `EIGH_CHUNK` chunks) on the
same matrices, at the shapes of `TIMED` with CUDA events; and the batched
gradient step of ``chip_smoke.py`` phase 6 (8 columns x 128 bands, 64
layers, float32) at NQuad = 32 and 48 with each version in turn launched
as kernel 4 on that path (``_build.swapped``), host clock, best of 3.
Exits nonzero if a check fails.  `chip_smoke.py` at the repository root
is the full run, on operands of real solves.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops.jacobi import default_sweeps

CHECKED = [(2, 7), (4, 33), (8, 100), (10, 17), (16, 1), (16, 1000), (22, 77), (24, 300), (24, 1025), (30, 40),
           (32, 65)]
# per-reading limits: sorted w against float64 (relative to the lane's
# largest |w|), per-lane max |V^T V - I|, per-lane max |V diag(w) V^T - A|
# relative to the lane's largest |A|
LIMITS = {torch.float32: dict(w=3e-5, orth=1e-4, recon=3e-5),
          torch.float64: dict(w=1e-12, orth=1e-12, recon=1e-12)}
# A dense matrix without a dominant diagonal (`constant_diagonal_matrices`)
# needs one sweep more than `default_sweeps` in float32 at n >= 16 to
# reconstruct within LIMITS, the plain version as well; the eigen stage's
# operands converge in 4.  At the default count such a batch is held on
# sorted w and orthogonality (`DEFAULT_SWEEP_READINGS`), and on every
# reading one sweep later.
DEFAULT_SWEEP_READINGS = ("w", "orth")
EIGH_CHUNK = 16384     # cuSOLVER's batched eigh refuses 32768 or more matrices


def lanes(A, dtype):
    """(B, n, n) numpy -> (n, n, B) contiguous CUDA tensor."""
    return torch.tensor(np.moveaxis(A, 0, -1), dtype=dtype, device="cuda").contiguous()


def scan_matrices(n, B, seed, dtype):
    """The TPU kernel's regression scan: symmetric noise of scale 0.1 on a
    diagonal ramp from 1 to 4 (tests_tpu/test_tpu_production.py)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    return lanes((base + np.swapaxes(base, -1, -2)) / 2 + np.eye(n) * np.linspace(1, 4, n), dtype)


def tied_matrices(n, B, seed, dtype):
    """Symmetric matrices whose diagonal holds each of n/2 values twice, in
    a random order per lane: the pairs that meet with equal carried
    diagonals have theta == 0 exactly."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.1
    A = (base + np.swapaxes(base, -1, -2)) / 2
    idx = np.arange(n)
    A[:, idx, idx] = rng.permuted(np.broadcast_to(np.repeat(np.linspace(1, 4, n // 2), 2), (B, n)), axis=1)
    return lanes(A, dtype)


def constant_diagonal_matrices(n, B, seed, dtype):
    """Symmetric matrices whose diagonal entries are all 2: every pair of
    every round of the first sweep is tied (n = 2: [[2, a], [a, 2]])."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, n, n)) * 0.3
    A = (base + np.swapaxes(base, -1, -2)) / 2
    idx = np.arange(n)
    A[:, idx, idx] = 2.0
    return lanes(A, dtype)


def eigvalsh64(At):
    """Ascending float64 eigenvalues (B, n) of lanes ``At``, in chunks."""
    A = At.double().permute(2, 0, 1)
    return torch.cat([torch.linalg.eigvalsh(A[b:b + EIGH_CHUNK]) for b in range(0, A.shape[0], EIGH_CHUNK)])


def readings(At, w, V, w64=None):
    """Order-free readings of ``w`` (n, B), ``V`` (n, n, B) for ``At``: sorted
    w against the ascending float64 eigenvalues ``w64`` (B, n) (relative and
    absolute), per-lane orthogonality, per-lane reconstruction (relative
    and absolute), each the largest over the lanes, and the per-lane
    absolute reconstruction errors."""
    A = At.double().permute(2, 0, 1)
    w, V = w.double().T, V.double().permute(2, 0, 1)
    w64 = eigvalsh64(At) if w64 is None else w64
    scale = A.abs().amax(dim=(1, 2))
    eye = torch.eye(A.shape[1], dtype=torch.float64, device=A.device)
    recon = (V @ (w[:, :, None] * V.mT) - A).abs().amax(dim=(1, 2))
    w_err = (w.sort(dim=1).values - w64).abs().amax(dim=1)
    return dict(
        w=(w_err / w64.abs().amax(dim=1)).max().item(),
        w_abs=w_err.max().item(),
        orth=(V.mT @ V - eye).abs().amax(dim=(1, 2)).max().item(),
        recon=(recon / scale).max().item(),
        recon_abs=recon.max().item(),
        lanes_abs=recon,
    )


def check_readings(label, r, dtype, log=print, keys=None, limits=None):
    """Log the readings and hold them (``keys``, default all) to ``limits``
    (default `LIMITS`); returns the failed count."""
    lim = limits or LIMITS[dtype]
    bad = [k for k in (keys or lim) if not r[k] < lim[k]]
    log(f"  {label}: sorted w rel {r['w']:.3e}, per-lane |V^T V - I| {r['orth']:.3e}, "
        f"|V diag(w) V^T - A| rel {r['recon']:.3e} (abs {r['recon_abs']:.3e}) "
        + ("ok" if not bad else f"FAILED {bad}"))
    return len(bad)


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


# timed shapes: (label, n, B, dtype): the bench chunk's congruence M and the
# NQuad=48 chunk's (the gradient steps' eigen stage) in float32 and float64,
# and the lanes of a 64-layer NQuad=32 column's gradient
TIMED = [("bench chunk", 16, 65536, torch.float32), ("NQuad=48 chunk", 24, 65536, torch.float32),
         ("bench chunk", 16, 65536, torch.float64), ("NQuad=48 chunk", 24, 65536, torch.float64),
         ("64-layer column", 16, 2048, torch.float32)]


def entry_call(fn, At, sweeps):
    """A launch of the C entry ``fn`` of a kernel-4 version on ``At``, its
    outputs allocated here once; returns the launch function and (w, V)."""
    n, _, B = At.shape
    w = torch.empty((n, B), dtype=At.dtype, device=At.device)
    V = torch.empty_like(At)
    ptrs = [At.data_ptr(), w.data_ptr(), V.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    return (lambda: fn(*ptrs, n, B, sweeps, stream)), (w, V)


def check_version(version):
    """Hold one version (a `_build.Build`) to `LIMITS` through its C entry;
    returns the failed count."""
    failed = 0

    def eig(At, more=0):
        call, out = entry_call(version.entry(At.dtype), At, default_sweeps(At.shape[0], At.dtype) + more)
        if call():
            raise RuntimeError(f"{version.label}: launch failed at {tuple(At.shape)}")
        torch.cuda.synchronize()
        return out

    print(f"checks of {version.label}", flush=True)
    for n, B in CHECKED:
        for dtype in (torch.float32, torch.float64):
            for what, make in (("ramp", scan_matrices), ("tied pairs", tied_matrices),
                               ("constant diagonal", constant_diagonal_matrices)):
                At = make(n, B, 10 * n + B, dtype)
                label = f"n={n} B={B} {str(dtype)[6:]} {what}"
                dense = make is constant_diagonal_matrices
                failed += check_readings(label, readings(At, *eig(At)), dtype,
                                         keys=DEFAULT_SWEEP_READINGS if dense else None)
                if dense:
                    failed += check_readings(f"{label}, one sweep more", readings(At, *eig(At, 1)), dtype)
    At = scan_matrices(16, 131072, 0, torch.float32)
    r = readings(At, *eig(At))
    n_bad = int((r["lanes_abs"] > 1e-3).sum())
    ok = n_bad == 0 and r["recon_abs"] < 1e-4
    print(f"  scan n=16 B=131072 float32: {n_bad} lanes above 1e-3, max {r['recon_abs']:.3e} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return failed + (not ok)


def library_eigh(At):
    """``torch.linalg.eigh`` on the (B, n, n) matrices of ``At``, in chunks."""
    A = At.permute(2, 0, 1)
    for b in range(0, A.shape[0], EIGH_CHUNK):
        torch.linalg.eigh(A[b:b + EIGH_CHUNK])


def time_versions(versions, reps=10):
    """Every version, kernel 5 and the library call at the shapes of
    `TIMED`, in turns."""
    from .check_wide import jacobi_entry

    kernel5 = _build.current("jacobi_eigh_wide")
    for label, n, B, dtype in TIMED:
        At = scan_matrices(n, B, 1, dtype)
        sweeps = default_sweeps(n, dtype)
        calls = [(v.label, entry_call(v.entry(dtype), At, sweeps)[0]) for v in versions]
        calls.append(("kernel 5 (jacobi_eigh_wide.cu)", jacobi_entry(kernel5, At, sweeps)[0]))
        times = {}
        for name, call in calls + calls[::-1]:
            if call():
                raise RuntimeError(f"{name}: launch failed at n={n} B={B}")
            times.setdefault(name, []).append(cuda_ms(call, reps))
        times["torch.linalg.eigh"] = [cuda_ms(lambda: library_eigh(At), 2)]
        print(f"time {label} n={n} B={B} {str(dtype)[6:]}, {sweeps} sweeps (C entry, ms):", flush=True)
        for name, ts in times.items():
            print(f"    {' '.join(f'{t:.4f}' for t in ts)}  {name}", flush=True)


def gradient_step(arrs, dtype, device, nquad=32, wrt="omega"):
    """One gradient step of the batched path as a function: d loss / d wrt
    of the arrays ``arrs`` (`check_bvp.bench_arrays`'s keys) with loss =
    sum(fup^2) + sum(fdn * fdir) (the loss of
    tests_tpu/test_tpu_production.py's gradient test), ``arrs[wrt]``
    (``"omega"`` or ``"mu0"``) a leaf that make_batched_problem keeps as
    the problem's own."""
    import pythonic_disort_torch as pt
    from .check_bvp import batched_problem

    leaf = torch.tensor(arrs[wrt], dtype=dtype, device=device, requires_grad=True)
    prob = batched_problem(dict(arrs, **{wrt: leaf}), nquad, dtype, device)

    def step():
        fup, fdn, fdir = pt.solve_fluxes(prob, prob.tau_arr)
        return torch.autograd.grad((fup**2).sum() + (fdn * fdir).sum(), leaf)[0]

    return step


def time_gradient_steps(versions, reps=3):
    """The gradient step at NQuad = 32 and 48 with each version launched
    as kernel 4 (`_build.swapped`), in turns; host clock around
    synchronized steps, best of ``reps``."""
    from .check_bvp import bench_arrays

    for nquad, seed in ((32, 42), (48, 13)):
        step = gradient_step(bench_arrays(8, seed=seed, nquad=nquad), torch.float32, "cuda", nquad)
        times = {}
        for version in versions + versions[::-1]:
            with _build.swapped(version):
                step()
                ts = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    ts.append(1e3 * (time.perf_counter() - t0))
            times.setdefault(version.label, []).append(min(ts))
        print(f"time gradient step NQuad={nquad}, 8 columns x 128 bands, L=64, float32 "
              f"(host clock, best of {reps}, ms):", flush=True)
        for name, ts in times.items():
            print(f"    {' '.join(f'{t:.3f}' for t in ts)}  {name}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build, check and time kernel 4 (and other versions) on one GPU.")
    parser.add_argument("--source", nargs="*", default=[], help="other versions of jacobi_eigh.cu to check and time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_jacobi: CUDA is not available", file=sys.stderr)
        return 2
    from .check_wide import print_ptxas

    t0 = time.perf_counter()
    others = _build.start(["jacobi_eigh", "jacobi_eigh_wide"],
                          [(path, "jacobi_eigh", Path(path).read_text()) for path in args.source])()
    print(f"built jacobi_eigh, jacobi_eigh_wide and {len(others)} other versions in {time.perf_counter() - t0:.1f} s "
          f"on {torch.cuda.get_device_name(0)}", flush=True)
    versions = [_build.current("jacobi_eigh"), *others]
    for version in versions:
        print_ptxas(version.label, version.ptxas())
    tree = versions[0].ptxas()
    spilled = sum(v.spill_stores + v.spill_loads for v in tree)
    print(f"  jacobi_eigh.cu: {spilled} B spilled over {len(tree)} variants {'ok' if not spilled else 'FAILED'}",
          flush=True)
    failed = bool(spilled)
    for version in versions:
        failed += check_version(version)
    time_versions(versions)
    time_gradient_steps(versions)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
