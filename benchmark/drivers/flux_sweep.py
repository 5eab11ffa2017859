"""Flux-only shortwave sweep: chunks of columns x g-points handed in as
host arrays; each chunk is ``make_batched_problem`` -> ``solve_fluxes`` at
the layer bottoms -> ``.cpu()``, one after the other (a batch job)."""

from __future__ import annotations

from yardstick import reference, sweep


class Driver:
    def __init__(self, config, traffic, seed, device, probe):
        import torch
        import pythonic_disort_torch as pt

        self.config, self.traffic, self.probe = config, traffic, probe
        self.device, self.dtype = device, getattr(torch, config["dtype"])
        self.pool = sweep.Pool(config, traffic, seed)
        self.cfg = pt.DisortConfig(
            nquad=config["nquad"], nleg=config["nleg"], nleg_all=config["nleg_all"], nfourier=1,
            nlayers=config["layers"], nscoeffs=0, nbdrf=0, has_beam=True, only_flux=True, has_deltam=True)
        self.make, self.solve = pt.make_batched_problem, pt.solve_fluxes

    def step(self, i):
        p = i % self.pool.chunks
        a = self.pool.chunk(p)
        with self.probe.span("entry"):
            prob = self.make(self.cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"], f_arr=a["f_arr"],
                             dtype=self.dtype, device=self.device)
        with self.probe.span("solve"):
            out = self.solve(prob, prob.tau_arr)
        with self.probe.span("copy"):
            host = [x.cpu().numpy() for x in out]
        self.pool.keep(i, host)
        return self.pool.chunk_columns

    def warm(self):
        self.step(0)
        self.pool.kept.clear()

    def shapes(self):
        B, L, N = self.pool.rows_per_chunk, self.config["layers"], self.config["nquad"] // 2
        return {"eig": {"n": N, "lanes": B * L}, "bvp": {"L": L, "N": N, "lanes": B}}

    def release(self):
        self.make = self.solve = None

    def reference_rows(self, rows, rnd=reference.identity):
        a = {k: v[rows] for k, v in self.pool.arrays.items()}
        c = self.config
        sol = reference.solve(a["tau"], a["omega"], a["leg"], a["f_arr"], a["mu0"], a["I0"], a["phi0"],
                              c["nquad"], c["nleg"], 1, rnd=rnd)
        return reference.fluxes(sol, a["tau"], rnd) + (reference.beam_pole_distance(sol),)

    def control(self, rnd, calls=None):
        """Keep the reference computed through ``rnd`` as the outputs of one
        pass over the pool."""
        self.pool.fill(lambda rows: self.reference_rows(rows, rnd)[:3], 1)

    def readings(self):
        check = self.traffic["checks"]["flux_err"]
        return {"flux_err": sweep.flux_reading(self.pool, self.reference_rows, check["limit"], check["pole"])}
