"""Operations and bytes of the gradient path's stage kernels, frozen with
the benchmark: the generic block-Thomas solve (kernel 3, the boundary
value problem's transposed solve in the backward) and the two-sided
Jacobi (kernel 4, the eigen stage's eigendecomposition under a
gradient).  Peaks and the roofline share are `work.py`'s; bytes count
each input read once and each output written once.

The operation counts are those of the port's on-chip validation script
(``chip_smoke.py::blocktri_flops`` and ``jacobi_flops``), copied here so
that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

from .work import ITEM_BYTES

# two-sided Jacobi sweeps of kernel 4 at n <= 32 (`jacobi.default_sweeps`)
JACOBI_SWEEPS = {"float32": 5, "float64": 9}


def blocktri_flops(L, n):
    """Operations of the block-Thomas solve per lane: the layer correction
    [D | r] - Low [W | g] (L-1 layers, 2n^2(n+1)); the Gauss-Jordan
    elimination over n x (2n+1) in the first L-1 layers ((n-1)(3n^2+n)
    each) and over [dhat | rhat] alone in the last ((n-1)n(n+1)); the back
    substitution (L-1 layers, 2n^2)."""
    return (L - 1) * (2 * n * n * (n + 1) + (n - 1) * (3 * n * n + n) + 2 * n * n) + (n - 1) * n * (n + 1)


def blocktri_bytes(L, n, item):
    """Per lane: the lower, diagonal and upper blocks (3 L n^2) and the
    right-hand side (L n) in; the solution (L n) out."""
    return (3 * L * n * n + 2 * L * n) * item


def jacobi_flops(n, sweeps):
    """Operations of the two-sided Jacobi per lane: per sweep, for each of
    the n(n-1)/2 pairs, the pivot (about 20), the rotation of one triangle
    of A (6n) and of two rows of V (6n)."""
    return sweeps * (6 * n * n * (n - 1) + 10 * n * (n - 1))


def jacobi_bytes(n, item):
    """Per lane: A in (n^2); the eigenvalues (n) and V (n^2) out."""
    return (2 * n * n + n) * item


def stage_work(stage, shapes, dtype):
    """(operations, bytes) of one step's ``stage`` ("blocktri" or
    "jacobi") at the driver's ``shapes``: {"blocktri": {"L", "n", "lanes"},
    "jacobi": {"n", "lanes"}}."""
    s, item = shapes[stage], ITEM_BYTES[dtype]
    if stage == "blocktri":
        return blocktri_flops(s["L"], s["n"]) * s["lanes"], blocktri_bytes(s["L"], s["n"], item) * s["lanes"]
    return jacobi_flops(s["n"], JACOBI_SWEEPS[dtype]) * s["lanes"], jacobi_bytes(s["n"], item) * s["lanes"]
