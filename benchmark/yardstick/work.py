"""Operations, bytes and peaks of the stage kernels, frozen with the
benchmark: a kernel's roofline share is the least time the chip could
take for its work, the larger of operations over peak FLOP/s and bytes
over peak bytes/s, over the time the kernel took.  Bytes count each
input read once and each output written once.

The operation counts are those of the port's on-chip validation script
(``chip_smoke.py::eig_flops`` and ``bvp_flops``), copied here so that a
later change to the program cannot move the yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s; FLOP/s outside the tensor
# cores, at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "float64": 34e12}
ITEM_BYTES = {"float32": 4, "float64": 8}
# one-sided Jacobi sweeps of the eigen stage (kernel 1) in float32
EIG_SWEEPS = {"float32": 5, "float64": 9}


def eig_flops(n, sweeps):
    """Operations of the eigen stage per lane: two Cholesky factorizations
    (n^3/3 each), the congruence M = L^T (-At) L (2n^3), the Jacobi sweeps
    (n - 1 rounds of n/2 pairs; a pair takes one 2n dot and the rotation
    of its two rows of C and of Z, 12n: 7n^2(n - 1) per sweep) and the
    back-transforms (2n^3) with the scalings by K (2n^2)."""
    return 2 * n**3 / 3 + 2 * n**3 + 7 * n * n * (n - 1) * sweeps + 2 * n**3 + 2 * n * n


def eig_bytes(n, item):
    """Per lane: At and Bt in (2n^2); K, V, Y, P and Q out (n + 4n^2)."""
    return (2 * n * n + 4 * n * n + n) * item


def bvp_flops(L, N):
    """Operations of the fused boundary-value solve per lane: the layer
    correction (L - 1 layers), the Gauss-Jordan elimination of the
    2N x (3N + 1) system (L layers) and the back substitution."""
    corr = 2 * N * (2 * N * (N + 1) + 2 * N * N)
    gj = 4 * N * (4 * N * N + 3 * N)
    back = 8 * N * N
    return (L - 1) * corr + L * gj + (L - 1) * back


def bvp_bytes(L, N, item):
    """Per lane: eigenvector blocks (L 4N^2), decays (L N), bottom rows
    (2N^2) and right-hand side (L 2N) in; the solution (L 2N) out."""
    return (L * 4 * N * N + L * N + 2 * N * N + 2 * L * 2 * N) * item


def stage_work(stage, shapes, dtype):
    """(operations, bytes) of one step's ``stage`` ("eig" or "bvp") at the
    driver's ``shapes``: {"eig": {"n", "lanes"}, "bvp": {"L", "N", "lanes"}}."""
    s, item = shapes[stage], ITEM_BYTES[dtype]
    if stage == "eig":
        return eig_flops(s["n"], EIG_SWEEPS[dtype]) * s["lanes"], eig_bytes(s["n"], item) * s["lanes"]
    return bvp_flops(s["L"], s["N"]) * s["lanes"], bvp_bytes(s["L"], s["N"], item) * s["lanes"]


def roofline_pct(flops, nbytes, seconds, dtype):
    """Least time over ``seconds``, in percent."""
    least = max(flops / PEAK_FLOP_S[dtype], nbytes / PEAK_BYTES_S)
    return 100.0 * least / seconds
