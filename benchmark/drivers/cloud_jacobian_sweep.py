"""TOA radiance Jacobians through a Cloud C.1 deck: `cloud_radiance_sweep`'s
columns and deck, and per chunk a retrieval's adjoint step on the port's
normal path.  The layer bottoms ``tau_arr`` and the albedos ``omega_arr``
go to the device as leaves that take a gradient ->
``make_batched_problem`` -> ``solve_intensity`` on the general path at
tau = 0 with the Nakajima-Tanaka corrections -> the loss ``sum(v * u)``
over the upward streams, ``v`` the seeded weighted residual
(`yardstick/jacobian.py`) -> ``torch.autograd.grad`` with respect to
(tau_arr, omega_arr) -> ``u`` and both gradients to the host."""

from __future__ import annotations

import numpy as np

from drivers import cloud_radiance_sweep
from yardstick import compare, jacobian, sweep

# rows of one reference block: bounds its (rows, modes, layers, 2N, 2N)
# tensors and their saved graph to about a GB at NQuad = 48
REF_ROWS = 4


class Driver(cloud_radiance_sweep.Driver):
    def __init__(self, config, traffic, seed, device, probe):
        import torch

        obs = config["observation"]
        super().__init__(config, {**traffic, "phi": obs["phi"], "nt_correct": True}, seed, device, probe)
        self.N = config["nquad"] // 2
        B = self.pool.rows_per_chunk
        self.tau_eval = torch.full((B, 1), float(obs["tau"]), dtype=self.dtype, device=device)
        self.v_host = jacobian.cotangents(seed, self.pool.rows, self.N, len(self.phi))
        self.v = torch.as_tensor(self.v_host, dtype=self.dtype, device=device)

    def step(self, i):
        import torch

        p = i % self.pool.chunks
        a = self.pool.chunk(p)
        lo = p * self.pool.rows_per_chunk
        with self.probe.span("entry"):
            tau = torch.tensor(a["tau"], dtype=self.dtype, device=self.device).requires_grad_()
            omega = torch.tensor(a["omega"], dtype=self.dtype, device=self.device).requires_grad_()
            prob = self.make(self.cfg, tau, omega, a["leg"], a["mu0"], a["I0"], phi0=a["phi0"],
                             f_arr=a["f_arr"], dtype=self.dtype, device=self.device)
        with self.probe.span("solve"):
            u = self.solve(prob, self.tau_eval, self.phi_eval)[:, :self.N]
            loss = (self.v[lo:lo + self.pool.rows_per_chunk] * u).sum()
            g_tau, g_omega = torch.autograd.grad(loss, (tau, omega))
        with self.probe.span("copy"):
            host = [u[:, :, 0].detach().cpu().numpy(), g_tau.cpu().numpy(), g_omega.cpu().numpy()]
        self.pool.keep(i, host)
        return self.pool.chunk_columns

    def shapes(self):
        B, L, N = self.pool.rows_per_chunk, self.config["layers"], self.N
        lanes = B * self.nf
        return {"eig": {"n": N, "lanes": lanes * L}, "bvp": {"L": L, "N": N, "lanes": lanes},
                "blocktri": {"L": L, "n": 2 * N, "lanes": lanes}, "jacobi": {"n": N, "lanes": lanes * L}}

    def release(self):
        super().release()
        self.v = self.tau_eval = None

    def reference_rows(self, rows, dtype=None):
        """``(u, d loss / d tau, d loss / d omega, pole distance)`` of the
        pool rows ``rows`` from the plain reference, in float64 unless
        ``dtype`` says otherwise, on the driver's device."""
        import torch

        a = {k: v[rows] for k, v in self.pool.arrays.items()}
        return jacobian.reference(a, self.v_host[rows], self.config, self.phi, self.nf, dtype or torch.float64, self.device)

    def control(self, rnd, calls=None):
        """The plain reference in float32 in the program's place (the
        configuration's precision is float64; ``rnd`` is the NumPy
        reference's rounding and has no use here)."""
        import torch

        self.pool.fill(lambda rows: self.reference_rows(rows, torch.float32)[:3], sweep.REF_BLOCK // REF_ROWS)

    def readings(self):
        checks = self.traffic["checks"]
        got = self.pool.gathered()
        if got is None:
            return {k: compare.reading(float("inf"), c["limit"]) for k, c in checks.items()}
        steps, rows, (u, g_tau, g_omega) = got
        uniq, inv = np.unique(rows, return_inverse=True)
        ref_u, ref_tau, ref_omega, dist = sweep.in_blocks(uniq, sweep.REF_BLOCK // REF_ROWS, self.reference_rows)
        d = dist[inv]
        out = {}
        for name, got_, ref in (("u_err", u, ref_u[inv]),
                                ("grad_err", np.concatenate([g_tau, g_omega], axis=1),
                                 np.concatenate([ref_tau, ref_omega], axis=1)[inv])):
            err = compare.conditioned(compare.row_errors(got_, ref), d, checks[name]["pole"])
            compare.report(name, err, steps, rows, d)
            out[name] = compare.reading(err.max(), checks[name]["limit"])
        return out
