"""Longwave sweep from temperature profiles: chunks of columns x g-points;
each chunk runs the port's device Planck route (per band one
``s_poly_coeffs_from_temper`` over its g-points' optical depths and one
``band_integrated_emission`` at the surface), shares each band's emission
among its g-points by their Planck fractions, then
``make_batched_problem`` -> ``solve_fluxes`` at the layer bottoms ->
``.cpu()``."""

from __future__ import annotations

import numpy as np

from yardstick import planck, reference, sweep


class Driver:
    def __init__(self, config, traffic, seed, device, probe):
        import torch
        import pythonic_disort_torch as pt
        from pythonic_disort_torch.ops import planck as device_planck

        self.torch = torch
        self.config, self.traffic, self.probe = config, traffic, probe
        self.device, self.dtype = device, getattr(torch, config["dtype"])
        self.pool = sweep.Pool(config, traffic, seed)
        self.edges = [float(x) for x in config["band_edges"]]
        self.bands, self.per_band = len(self.edges) - 1, config["gpoints_per_band"]
        self.cfg = pt.DisortConfig(
            nquad=config["nquad"], nleg=config["nleg"], nleg_all=config["nleg_all"], nfourier=1,
            nlayers=config["layers"], nscoeffs=2, nbdrf=0, has_beam=False, only_flux=True, has_deltam=True)
        B = self.pool.rows_per_chunk
        self.frac = torch.as_tensor(self.pool.arrays["fractions"], dtype=self.dtype, device=device)
        self.zeros = np.zeros(B)
        self.make, self.solve = pt.make_batched_problem, pt.solve_fluxes
        self.s_poly, self.emission = device_planck.s_poly_coeffs_from_temper, device_planck.band_integrated_emission

    def step(self, i):
        torch = self.torch
        p = i % self.pool.chunks
        a = self.pool.chunk(p)
        C, L, N = self.pool.chunk_columns, self.config["layers"], self.config["nquad"] // 2
        B = self.pool.rows_per_chunk
        with self.probe.span("planck", sync=True):
            tau = torch.as_tensor(a["tau"], dtype=self.dtype, device=self.device)
            temper = torch.as_tensor(self.pool.arrays["temper"][p * C:(p + 1) * C], dtype=self.dtype,
                                     device=self.device)
            tau_cb = tau.view(C, self.bands, self.per_band, L)
            s_poly, surface = [], []
            for k in range(self.bands):
                lo, hi = self.edges[k], self.edges[k + 1]
                s_poly.append(self.s_poly(tau_cb[:, k], temper[:, None, :], lo, hi))
                surface.append(self.emission(temper[:, -1], lo, hi))
            s_poly = (torch.stack(s_poly, dim=1) * self.frac[None, :, :, None, None]).reshape(B, L, 2)
            b_pos = (torch.stack(surface, dim=1)[:, :, None] * self.frac[None]).reshape(B, 1, 1).expand(B, N, 1)
        with self.probe.span("entry"):
            prob = self.make(self.cfg, tau, a["omega"], a["leg"], self.zeros, self.zeros, f_arr=a["f_arr"],
                             b_pos=b_pos, s_poly_coeffs=s_poly, dtype=self.dtype, device=self.device)
        with self.probe.span("solve"):
            out = self.solve(prob, prob.tau_arr)
        with self.probe.span("copy"):
            host = [x.cpu().numpy() for x in out]
        self.pool.keep(i, host)
        return C

    def warm(self):
        self.step(0)
        self.pool.kept.clear()

    def shapes(self):
        B, L, N = self.pool.rows_per_chunk, self.config["layers"], self.config["nquad"] // 2
        return {"eig": {"n": N, "lanes": B * L}, "bvp": {"L": L, "N": N, "lanes": B}}

    def release(self):
        self.make = self.solve = self.frac = None

    def sources(self, rows):
        """The float64 Planck sources of pool ``rows``: ``s_poly`` (R, L, 2)
        and the surface's upward intensity (R,)."""
        gp = self.config["gpoints"]
        col, g = rows // gp, rows % gp
        band, gi = g // self.per_band, g % self.per_band
        frac = self.pool.arrays["fractions"][band, gi]
        temper = self.pool.arrays["temper"][col]
        E = np.stack([planck.band_emission(temper[r], self.edges[band[r]], self.edges[band[r] + 1])
                      for r in range(len(rows))]) * frac[:, None]                     # (R, L + 1)
        tau = self.pool.arrays["tau"][rows]
        grid = np.concatenate([np.zeros((len(rows), 1)), tau], axis=1)
        slope = np.diff(E, axis=1) / np.diff(grid, axis=1)
        return np.stack([E[:, :-1] - slope * grid[:, :-1], slope], axis=-1), E[:, -1]

    def reference_rows(self, rows, rnd=reference.identity):
        a = {k: v[rows] for k, v in self.pool.arrays.items() if v.shape[0] == self.pool.rows}
        c = self.config
        s_poly, b_pos = self.sources(rows)
        R = len(rows)
        sol = reference.solve(a["tau"], a["omega"], a["leg"], a["f_arr"], np.full(R, 0.5), np.zeros(R),
                              np.zeros(R), c["nquad"], c["nleg"], 1, s_poly=s_poly, b_pos=b_pos, has_beam=False,
                              rnd=rnd)
        return reference.fluxes(sol, a["tau"], rnd) + (np.full(R, np.inf),)

    def control(self, rnd, calls=None):
        self.pool.fill(lambda rows: self.reference_rows(rows, rnd)[:3], 1)

    def readings(self):
        check = self.traffic["checks"]["flux_err"]
        return {"flux_err": sweep.flux_reading(self.pool, self.reference_rows, check["limit"], check["pole"])}
