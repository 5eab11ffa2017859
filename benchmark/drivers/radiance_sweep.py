"""Shortwave radiance sweep: chunks of columns x g-points; each chunk is
``make_batched_problem`` -> ``solve_intensity(probes_per_layer=True)``
with the Nakajima-Tanaka corrections, one probe just above each layer's
bottom and a few azimuths -> ``.cpu()``."""

from __future__ import annotations

import numpy as np

from yardstick import compare, reference, sweep


class Driver:
    def __init__(self, config, traffic, seed, device, probe):
        import torch
        import pythonic_disort_torch as pt

        self.config, self.traffic, self.probe = config, traffic, probe
        self.device, self.dtype = device, getattr(torch, config["dtype"])
        self.pool = sweep.Pool(config, traffic, seed)
        self.nf = traffic["nfourier"]
        self.cfg = pt.DisortConfig(
            nquad=config["nquad"], nleg=config["nleg"], nleg_all=config["nleg_all"], nfourier=self.nf,
            nlayers=config["layers"], nscoeffs=0, nbdrf=0, has_beam=True, only_flux=False,
            nt_correct=traffic["nt_correct"], has_deltam=True)
        self.phi = np.asarray(traffic["phi"], np.float64)
        B = self.pool.rows_per_chunk
        self.phi_eval = torch.as_tensor(np.tile(self.phi, (B, 1)), dtype=self.dtype,
                                        device=device)
        self.make, self.solve = pt.make_batched_problem, pt.solve_intensity

    def step(self, i):
        p = i % self.pool.chunks
        a = self.pool.chunk(p)
        with self.probe.span("entry"):
            prob = self.make(self.cfg, a["tau"], a["omega"], a["leg"], a["mu0"], a["I0"], phi0=a["phi0"],
                             f_arr=a["f_arr"], dtype=self.dtype, device=self.device)
            tau_eval = prob.tau_arr * (1.0 - self.traffic["probe_offset"])
        with self.probe.span("solve"):
            u = self.solve(prob, tau_eval, self.phi_eval, probes_per_layer=True)
        with self.probe.span("copy"):
            host = u.cpu().numpy()
        self.pool.keep(i, [host])
        return self.pool.chunk_columns

    def warm(self):
        self.step(0)
        self.pool.kept.clear()

    def shapes(self):
        B, L, N = self.pool.rows_per_chunk, self.config["layers"], self.config["nquad"] // 2
        return {"eig": {"n": N, "lanes": B * self.nf * L}, "bvp": {"L": L, "N": N, "lanes": B * self.nf}}

    def release(self):
        self.make = self.solve = self.phi_eval = None

    def reference_rows(self, rows, rnd=reference.identity):
        a = {k: v[rows] for k, v in self.pool.arrays.items()}
        c = self.config
        sol = reference.solve(a["tau"], a["omega"], a["leg"], a["f_arr"], a["mu0"], a["I0"], a["phi0"],
                              c["nquad"], c["nleg"], self.nf, rnd=rnd)
        tau_eval = a["tau"] * (1.0 - self.traffic["probe_offset"])
        u = reference.intensity(sol, tau_eval, np.broadcast_to(self.phi, (len(rows), len(self.phi))),
                                nt_correct=self.traffic["nt_correct"], rnd=rnd)
        dist = reference.beam_pole_distance(sol)
        if self.traffic["nt_correct"]:
            dist = np.minimum(dist, reference.nt_pole_distance(sol))
        return u, dist

    def control(self, rnd, calls=None):
        self.pool.fill(lambda rows: self.reference_rows(rows, rnd)[:1], self.nf)

    def readings(self):
        check = self.traffic["checks"]["u_err"]
        got = self.pool.gathered()
        if got is None:
            return {"u_err": compare.reading(float("inf"), check["limit"])}
        steps, rows, (u,) = got
        uniq, inv = np.unique(rows, return_inverse=True)
        ref, dist = sweep.in_blocks(uniq, self.nf, self.reference_rows)
        err = compare.conditioned(compare.row_errors(u, ref[inv]), dist[inv], check["pole"])
        compare.report("u_err", err, steps, rows, dist[inv])
        return {"u_err": compare.reading(err.max(), check["limit"])}
