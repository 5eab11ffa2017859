"""Compile-and-check call for ``csrc/legendre_series.cu`` on one NVIDIA GPU.

    python3 -m pythonic_disort_torch.tools.check_legendre

Builds ``legendre_series`` alone and prints what ptxas reports for its
float32 and float64 variants (a spill fails the check).  Then it holds
`legendre.legendre_series_bcast` on the card, which launches the kernel,
to the plain loop (`legendre._clenshaw`) run on the card on the same
operands: the outputs must have equal bits, and where they do not the
largest difference is printed and the check fails.

- the NT correction's three series (``models/disort/nt.py``: the IMS
  residual, the TMS's exact and truncated phase functions) at the step
  shapes of the benchmark's two radiance cells (`CELLS`), in float64 as
  the cells run and in float32;
- rows at ndeg 1, 2 and odd, Q of 1, not a multiple of a warp, above the
  kernel's 256-point block and above its 2048-coefficient tile, R ragged.

It checks the routes: one launch (``profiling.recorded()["launches"]``)
and ``ndeg`` ``legendre_terms`` a series on the kernel's route; no launch
and the same terms where the operands take a gradient, no launch where
they carry a forward-mode tangent (outputs and derivatives the plain
loop's bits), one launch under ``no_grad``.  Last it times, with CUDA events,
each series of both cells on both routes in turns (loop, kernel, kernel,
loop), the kernel's launch alone on operands already in rows, and the
kernel against its bound (operations at the card's rate
outside the tensor cores, or the bytes of coefficients, points and
output).  Exits nonzero if a check fails.  ``chip_smoke.py`` at the
repository root is the full run.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.profiler import ProfilerActivity, profile

from ..ops import _build, legendre
from ..utils import profiling
from .check_blocktri import cuda_ms
from .check_wide import print_ptxas

# The NT correction's three series in one chunk of each radiance cell:
# cell -> (S solves, L layers, N streams a hemisphere, azimuths, NLeg_all, NLeg)
CELLS = {"cloud_radiance": (112, 60, 24, 4, 300, 48), "sw_radiance": (448, 60, 16, 4, 33, 32)}
# rows (R, Q, ndeg) at the kernel's edges
EDGES = [(1, 1, 1), (3, 5, 2), (7, 33, 7), (5, 257, 48), (3, 513, 301), (1000, 3, 5), (2, 64, 2500),
         (77, 100, 299)]
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, and float32 /
# float64 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}


def moments(batch, ndeg, seed, dtype):
    """Phase-function moments (2l + 1) w g^l on the card, g in [0.5, 0.9],
    |w| in [0.5, 1] with a random sign, shape ``batch + (ndeg,)``."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 0.9, batch + (1,))
    w = rng.uniform(0.5, 1.0, batch + (1,)) * rng.choice([-1.0, 1.0], batch + (1,))
    ell = np.arange(ndeg)
    return torch.as_tensor((2 * ell + 1) * w * g**ell, dtype=dtype, device="cuda")


def points(shape, seed, dtype):
    """Points in [-1, 1] on the card, both ends among them."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).reshape(-1)
    x[:2] = (-1.0, 1.0)[: x.size]
    return torch.as_tensor(x.reshape(shape), dtype=dtype, device="cuda")


def nt_series(dims, dtype, seed=0):
    """{label: (coeffs, x)} of the three series of a chunk of ``dims``
    (a value of `CELLS`), shaped as ``nt_correction`` calls them."""
    S, L, N, P, nleg_all, nleg = dims
    nu = points((S, 1, 2 * N, P), seed + 1, dtype)
    return {"ims": (moments((S, 1, 1), nleg_all, seed + 2, dtype), points((S, N, P), seed, dtype)),
            "tms_exact": (moments((S, L, 1, 1), nleg_all, seed + 3, dtype), nu),
            "tms_truncated": (moments((S, L, 1, 1), nleg, seed + 4, dtype), nu)}


def loop(coeffs, x):
    return legendre._clenshaw(coeffs, x, torch.broadcast_shapes(coeffs.shape[:-1], x.shape))


def counted(run):
    """``run()`` under a profiler, synchronized: (output, launches of
    ``legendre_series``, ``legendre_terms``)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
        torch.cuda.synchronize()
    rec = profiling.recorded()
    profiling.reset()
    return out, Counter(rec["launches"])["legendre_series"], rec["counters"].get("legendre_terms", 0)


def differ(a, b):
    """'' where ``a`` and ``b`` have equal bits, else what differs."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return f"{tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}"
    if torch.equal(a, b):
        return ""
    d = (a - b).abs()
    i = int(d.argmax())
    return (f"{int((a != b).sum())} of {a.numel()} differ, largest {float(d.max()):.3e} at flat {i} "
            f"({float(a.reshape(-1)[i]):.17g} against {float(b.reshape(-1)[i]):.17g})")


def check_bits(label, coeffs, x):
    """The kernel's route against the plain loop on the card; True if the
    bits are equal, one launch ran (none in the loop) and ``ndeg``
    ``legendre_terms`` were counted."""
    ndeg = coeffs.shape[-1]
    got, launched, terms = counted(lambda: legendre.legendre_series_bcast(coeffs, x))
    ref, plain_launched, _ = counted(lambda: loop(coeffs, x))
    bad = differ(got, ref)
    ok = not bad and launched == 1 and plain_launched == 0 and terms == ndeg
    print(f"{label}: {'equal bits' if not bad else bad}; launches {launched} (loop {plain_launched}), "
          f"legendre_terms {terms} {'ok' if ok else 'FAILED'}", flush=True)
    return ok


def check_gradient_routes():
    """Operands that take a gradient or carry a forward-mode tangent keep
    the plain loop on the card: no launch, the loop's bits and derivatives."""
    coeffs, x = moments((6, 1), 40, 1, torch.float64), points((6, 70), 2, torch.float64)
    c, xr = coeffs.clone().requires_grad_(), x.clone().requires_grad_()
    out, launched, terms = counted(lambda: legendre.legendre_series_bcast(c, xr))
    grads = torch.autograd.grad(out.square().sum(), (c, xr))
    c0, x0 = coeffs.clone().requires_grad_(), x.clone().requires_grad_()
    ref = loop(c0, x0)
    ref_grads = torch.autograd.grad(ref.square().sum(), (c0, x0))
    ok_grad = launched == 0 and terms == 40 and not differ(out.detach(), ref.detach()) and not any(
        differ(a, b) for a, b in zip(grads, ref_grads))
    tc, tx = moments((6, 1), 40, 3, torch.float64), points((6, 70), 4, torch.float64)
    with fwAD.dual_level():
        dual, launched_fw, _ = counted(lambda: fwAD.unpack_dual(
            legendre.legendre_series_bcast(fwAD.make_dual(coeffs, tc), fwAD.make_dual(x, tx))))
        want = fwAD.unpack_dual(loop(fwAD.make_dual(coeffs, tc), fwAD.make_dual(x, tx)))
    ok_fw = launched_fw == 0 and not differ(dual.primal, want.primal) and not differ(dual.tangent, want.tangent)
    with torch.no_grad():
        _, launched_ng, _ = counted(lambda: legendre.legendre_series_bcast(c, xr))
    ok_ng = launched_ng == 1
    print(f"gradient route: launches {launched}, output and d/d(coeffs, x) the loop's bits "
          f"{'ok' if ok_grad else 'FAILED'}; forward mode: launches {launched_fw}, primal and tangent the loop's "
          f"bits {'ok' if ok_fw else 'FAILED'}; no_grad with requires_grad operands: launches {launched_ng} "
          f"{'ok' if ok_ng else 'FAILED'}", flush=True)
    return ok_grad + ok_fw + ok_ng == 3


def bound_ms(coeffs, x):
    """The least time the card could take for a series: its operations
    (5 a point and moment) at the rate outside the tensor cores, or the
    bytes of coefficients, points (as the call gives them) and output."""
    shape = torch.broadcast_shapes(coeffs.shape[:-1], x.shape)
    npts, ndeg = int(np.prod(shape)), coeffs.shape[-1]
    flops = 5.0 * npts * ndeg
    nbytes = (coeffs.numel() + x.numel() + npts) * coeffs.element_size()
    f_ms, b_ms = 1e3 * flops / PEAK_FLOP_S[coeffs.dtype], 1e3 * nbytes / PEAK_BYTES_S
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def time_series(cell, dtype):
    """Each series of one chunk of ``cell`` and the three together, on the
    plain loop and the kernel's route, in turns (loop, kernel, kernel,
    loop): ms a series."""
    series = nt_series(CELLS[cell], dtype, seed=11)
    name = str(dtype).removeprefix("torch.")
    runs = {"kernel": legendre.legendre_series_bcast, "loop": loop}
    for label, pair in [*series.items(), ("all three", None)]:
        if pair is None:
            calls = lambda fn: [fn(c, x) for c, x in series.values()]
        else:
            calls = lambda fn: fn(*pair)
        times = {}
        for route in ("loop", "kernel", "kernel", "loop"):
            fn = runs[route]
            times.setdefault(route, []).append(cuda_ms(lambda: calls(fn), 3 if route == "loop" else 20))
        line = f"  {cell} {label} {name}: loop {times['loop']} ms, kernel {times['kernel']} ms"
        if pair is not None:
            rows = legendre.row_operands(*pair, torch.broadcast_shapes(pair[0].shape[:-1], pair[1].shape))
            line += f", the rows' launch alone {cuda_ms(lambda: legendre.legendre_series_rows(*rows), 20):.4f} ms"
            b, by = bound_ms(*pair)
            line += (f"; bound {b:.4f} ms ({by}), kernel at {100 * b / min(times['kernel']):.1f} % of it; "
                     f"shape {tuple(pair[0].shape)} x {tuple(pair[1].shape)}")
        print(line, flush=True)


def main(argv=None):
    import argparse

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("check_legendre: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build(["legendre_series"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"built legendre_series in {time.perf_counter() - t0:.1f} s on {smi.stdout.strip() or 'nvidia-smi failed'}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    variants = _build.current("legendre_series").ptxas()
    print_ptxas("legendre_series", variants)
    failed = sum(v.spill_stores + v.spill_loads > 0 for v in variants) + (len(variants) != 2)
    for cell in CELLS:
        for dtype in (torch.float64, torch.float32):
            for label, (coeffs, x) in nt_series(CELLS[cell], dtype).items():
                failed += not check_bits(f"{cell} {label} {str(dtype)[6:]} {tuple(coeffs.shape)} x {tuple(x.shape)}",
                                         coeffs, x)
    for R, Q, ndeg in EDGES:
        for dtype in (torch.float64, torch.float32):
            coeffs, x = moments((R, 1), ndeg, R + ndeg, dtype), points((R, Q), Q, dtype)
            failed += not check_bits(f"rows R={R} Q={Q} ndeg={ndeg} {str(dtype)[6:]}", coeffs, x)
    failed += not check_gradient_routes()
    print("times, ms a series (CUDA events), in turns", flush=True)
    for cell in CELLS:
        for dtype in (torch.float64, torch.float32):
            time_series(cell, dtype)
    print(f"{failed} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
