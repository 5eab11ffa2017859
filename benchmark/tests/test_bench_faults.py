"""The comparison fails what it must: the timed path broken underneath a
whole run (the card's check skipped, the CPU at the tiny size), and the
control (the reference in TF32 in the program's place).

The faults a cell can have: a step that returns its state unchanged (the
previous step's outputs), half of the batch left out, and an answer
altered where it is produced.  No cell exchanges data between chips, so
the fault of an exchange left out has nothing to break.
"""

import functools

import numpy as np
import pytest

from conftest import CELLS, tiny

import control
import run

SWEEPS = ("sw_flux", "lw_flux_temper", "sw_radiance")


def stale(solve):
    """Every call after the first returns the first call's outputs."""
    first = []

    @functools.wraps(solve)
    def wrapped(*a, **k):
        if not first:
            first.append(solve(*a, **k))
        return first[0]

    return wrapped


def half(solve):
    """The second half of the batch left out: its outputs zero."""
    def wrapped(*a, **k):
        out = solve(*a, **k)
        for x in (out if isinstance(out, tuple) else (out,)):
            x[x.shape[0] // 2:] = 0
        return out

    return wrapped


def altered(solve, rows):
    """One output of one row of every batch off by 1 % of its row's
    largest: a row that ``rows()`` names (one the comparison samples)."""
    def wrapped(*a, **k):
        out = solve(*a, **k)
        x = out[0] if isinstance(out, tuple) else out
        flat = x[rows()].view(-1)
        flat[flat.numel() // 2] += 0.01 * flat.abs().max()
        return out

    return wrapped


def column_fault(kind):
    """The same faults in ``pydisort``'s closures: the first call's
    closures returned forever; the deeper half of the levels left out;
    one value of ``u`` off by 1 % of the call's largest."""
    def patch(drv):
        pydisort = drv.pydisort
        first = []

        def wrapped(*a, **k):
            outs = pydisort(*a, **k)
            if kind == "stale":
                first.append(first[0] if first else outs)
                return first[-1]
            mu, fu, fd, u0, u = outs
            if kind == "half":
                cut = lambda y: np.where(np.arange(np.shape(y)[-1]) >= np.shape(y)[-1] // 2, 0.0, y)
                return mu, lambda t: cut(fu(t)), lambda t: tuple(cut(y) for y in fd(t)), u0, u

            def u_altered(t, phi):
                y = np.array(u(t, phi))
                y.flat[7] += 0.01 * np.abs(y).max()
                return y

            return mu, fu, fd, u0, u_altered

        drv.pydisort = wrapped

    return patch


def sweep_fault(kind):
    def patch(drv):
        if kind == "altered":
            step, run_step = [0], drv.step

            def sampled_row():
                pool = drv.pool
                lo = (step[0] % pool.chunks) * pool.rows_per_chunk
                return int(pool.sample[(pool.sample >= lo) & (pool.sample < lo + pool.rows_per_chunk)][0] - lo)

            def tracked(i):
                step[0] = i
                return run_step(i)

            drv.step = tracked
            drv.solve = altered(drv.solve, sampled_row)
        else:
            drv.solve = FAULTS[kind](drv.solve)

    return patch


FAULTS = {"stale": stale, "half": half}


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", SWEEPS)
def test_sweep_fault_reads_incorrect(cell, fault):
    result = run.run_cell(cell, 2**31 + 5, 0.3, False, device="cpu", overrides=tiny(cell),
                          patch=sweep_fault(fault))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_column_fault_reads_incorrect(fault, column_root):
    result = run.run_cell("sw_column", 2**31 + 5, 0.3, False, device="cpu", overrides=tiny("sw_column"),
                          patch=column_fault(fault), root=column_root)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS + ("sw_column",))
def test_the_control_fails_the_limits(cell, column_root):
    """The reference in the precision below the configuration's reads above
    the limit of some number."""
    for seed in (11, 12, 13):
        readings = control.readings(cell, seed, calls=40, overrides=tiny(cell), root=column_root)
        assert any(r["value"] > r["limit"] for r in readings.values()), readings
