"""The observation, the cotangent and the reference of the gradient
cells, frozen with the benchmark; it imports nothing of the port.

A retrieval's adjoint step applies the transposed weighting functions to
a weighted residual, K^T S^-1 (y - F(x)) (Rodgers 2000, ch. 5): one
reverse-mode pass of the loss ``sum(v * u)``, with ``u`` the observed
radiances and ``v`` the weighted residual.  Here ``v`` is drawn: per pool
row, upward stream and azimuth one standard normal value, the residual of
an observation whose errors are independent and normalized by their
standard deviation, drawn on its own stream, ``numpy.random.default_rng(
[seed, 3])``, after the pool and the deck.
"""

from __future__ import annotations

import numpy as np

from . import reference_torch as rt

STREAM = 3


def cotangents(seed, rows, streams, azimuths):
    """(rows, streams, 1, azimuths) float64 weighted residuals: one value a
    pool row, observed stream, probe and azimuth."""
    return np.random.default_rng([seed, STREAM]).standard_normal((rows, streams, 1, azimuths))


def reference(a, v, config, phi, nfourier, dtype, device):
    """The plain reference's observation and state gradient of the rows
    ``a`` (the pool's arrays at those rows) with their cotangents ``v``,
    computed in ``dtype`` (a torch dtype) on ``device``: ``(u (R, N, P),
    d loss / d tau (R, L), d loss / d omega (R, L), pole distance (R,))``
    as float64 arrays, ``u`` the NT-corrected upward radiances at tau = 0
    and the loss ``sum(v * u)``."""
    import torch

    T = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    tau, omega = T(a["tau"]).requires_grad_(), T(a["omega"]).requires_grad_()
    sol = rt.solve(tau, omega, T(a["leg"]), T(a["f_arr"]), T(a["mu0"]), T(a["I0"]), T(a["phi0"]),
                   config["nquad"], config["nleg"], nfourier)
    R, N = tau.shape[0], config["nquad"] // 2
    u = rt.intensity(sol, torch.zeros((R, 1), dtype=dtype, device=device), T(np.tile(phi, (R, 1))),
                     nt_correct=True)[:, :N]
    g_tau, g_omega = torch.autograd.grad((T(v) * u).sum(), (tau, omega))
    dist = torch.minimum(rt.beam_pole_distance(sol), rt.nt_pole_distance(sol))
    host = lambda x: x.detach().cpu().double().numpy()
    return host(u[:, :, 0]), host(g_tau), host(g_omega), host(dist)
