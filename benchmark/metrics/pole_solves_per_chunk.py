"""Solves a chunk whose mu0 the beam's pole guard moved (the port's
``beam_pole_solves`` counter, summed on the device; traced sub-window): a
witness that the guard acts, 0 where it ran and moved nothing.  None
where the guard did not run (a port without it)."""

from yardstick import recorder


def read(ctx):
    rec = recorder.record() if ctx.trace is not None else None
    if rec is None or "disort.solve.pole" not in rec["spans"]:
        return None
    return rec["counters"].get("beam_pole_solves", 0) / ctx.trace_steps
