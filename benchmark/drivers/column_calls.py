"""One caller of the drop-in ``pydisort`` in a closed loop: each call takes
the next (column, g-point) of the pool in a seeded order, solves it, and
reads ``flux_up``, ``flux_down`` and ``u`` at every level (and a few
azimuths) back to the host through the returned closures."""

from __future__ import annotations

import numpy as np

from yardstick import compare, generator, reference, sweep


class Driver:
    def __init__(self, config, traffic, seed, device, probe):
        import torch
        import pythonic_disort_torch as pt

        self.config, self.traffic, self.probe = config, traffic, probe
        self.device, self.dtype = device, getattr(torch, config["dtype"])
        self.arrays = generator.pool(config, seed)
        self.rows = config["columns"] * config["gpoints"]
        self.order = generator.sample_rng(seed, 2).permutation(self.rows)
        self.seed = seed
        self.phi = np.asarray(traffic["phi"], np.float64)
        self.kept = []
        self.pydisort = pt.pydisort

    def levels(self, j):
        return np.concatenate([[0.0], self.arrays["tau"][j]])

    def step(self, i):
        j = int(self.order[i % self.rows])
        a = {k: v[j] for k, v in self.arrays.items()}
        with self.probe.span("pydisort"):
            _, flux_up, flux_down, _, u = self.pydisort(
                a["tau"], a["omega"], self.config["nquad"], a["leg"], float(a["mu0"]), float(a["I0"]),
                float(a["phi0"]), f_arr=a["f_arr"], NT_cor=self.traffic["nt_correct"], dtype=self.dtype,
                device=self.device)
        with self.probe.span("closures"):
            tau = self.levels(j)
            up = flux_up(tau)
            diffuse, direct = flux_down(tau)
            uu = u(tau, self.phi)
        self.kept.append((j, np.stack([up, diffuse, direct]), uu))
        return 1

    def warm(self):
        self.step(0)
        self.kept.clear()

    def shapes(self):
        L, N = self.config["layers"], self.config["nquad"] // 2
        return {"eig": {"n": N, "lanes": self.config["nquad"] * L}, "bvp": {"L": L, "N": N, "lanes": self.config["nquad"]}}

    def release(self):
        self.pydisort = None

    def reference_rows(self, rows, rnd=reference.identity):
        a = {k: v[rows] for k, v in self.arrays.items()}
        c = self.config
        sol = reference.solve(a["tau"], a["omega"], a["leg"], a["f_arr"], a["mu0"], a["I0"], a["phi0"],
                              c["nquad"], c["nleg"], c["nquad"], rnd=rnd)
        tau = np.concatenate([np.zeros((len(rows), 1)), a["tau"]], axis=1)
        fluxes = np.stack(reference.fluxes(sol, tau, rnd), axis=1)
        u = reference.intensity(sol, tau, np.broadcast_to(self.phi, (len(rows), len(self.phi))), rnd=rnd)
        return fluxes, u, reference.beam_pole_distance(sol)

    def sample(self, calls):
        """Indices of the compared calls among ``calls`` made, from the seed."""
        k = min(self.traffic["sample_calls"], calls)
        return np.sort(generator.sample_rng(self.seed, 3).choice(calls, k, replace=False))

    def control(self, rnd, calls):
        """Keep the reference computed through ``rnd`` as the outputs of the
        compared calls among ``calls``."""
        picked = self.sample(calls)
        rows = self.order[picked % self.rows]
        fluxes, u = sweep.in_blocks(rows, self.config["nquad"], lambda r: self.reference_rows(r, rnd)[:2])
        self.kept = [None] * calls
        for i, j, f, x in zip(picked, rows, fluxes, u):
            self.kept[i] = (int(j), f, x)

    def readings(self):
        fc, uc = self.traffic["checks"]["flux_err"], self.traffic["checks"]["u_err"]
        if not self.kept:
            return {"flux_err": compare.reading(float("inf"), fc["limit"]),
                    "u_err": compare.reading(float("inf"), uc["limit"])}
        calls = self.sample(len(self.kept))
        picked = [self.kept[i] for i in calls]
        rows = np.array([j for j, _, _ in picked])
        fluxes, u, dist = sweep.in_blocks(rows, self.config["nquad"], self.reference_rows)
        ferr = compare.conditioned(compare.row_errors(np.stack([f for _, f, _ in picked]), fluxes), dist, fc["pole"])
        uerr = compare.conditioned(compare.row_errors(np.stack([x for _, _, x in picked]), u), dist, uc["pole"])
        compare.report("flux_err", ferr, calls, rows, dist)
        compare.report("u_err", uerr, calls, rows, dist)
        return {"flux_err": compare.reading(ferr.max(), fc["limit"]), "u_err": compare.reading(uerr.max(), uc["limit"])}
