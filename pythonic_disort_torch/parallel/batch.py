"""Batched (columns x bands) solves: the port's production entry points.

Counterpart of ``pythonic_disort_tpu/parallel/batch.py``: fluxes
(``solve_fluxes``), the zeroth intensity mode (``u0_at``), full and
NT-corrected intensities (``solve_intensity``, ``u_at``,
``u_corrected_at``) and diffuse actinic fluxes (``solve_actinic``).  The
batch axis is written out as the leading axis of every tensor, and the
evaluators run on the whole batch at once.  Problems are
built on ``cuda`` unless the caller passes ``device="cpu"``; without a
card and without that request they raise rather than run on the CPU.

Over several ranks (`mesh`), ``solve_fluxes_sharded`` and
``solve_intensity_sharded`` solve this rank's shard with no collective,
and ``global_flux_stats`` reduces a diagnostic over mesh axes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.disort import eval as ev
from ..models.disort import nt
from ..models.disort.batch_solve import solve_batched, solve_batched_probes
from ..models.disort.solve import solve
from ..models.disort.types import DisortConfig, DisortProblem
from ..ops._build import has_tangent
from ..ops.legendre import normalized_assoc_legendre_host
from ..utils.profiling import count, from_host, span
from .mesh import BATCH_AXIS

# The production batched solve; `solve_vmapped`, the single-column `solve`
# row by row, is the independent cross-check of it.
solve_batch = solve_batched


def _tensor_fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)}


def solve_vmapped(problem: DisortProblem):
    """`solve` on each row of a batched problem, the solutions stacked into
    a batched ``DisortSolution`` (with ``G`` and ``GC``, as the single-column
    solve makes them).  The counterpart of the JAX package's
    ``jax.vmap(solve)``: the per-column cross-check of `solve_batch`."""
    fields = {k: v for k, v in _tensor_fields(problem).items() if k != "lam_mu0"}
    sols = [solve(dataclasses.replace(problem, lam_mu0=None, **{k: v[i] for k, v in fields.items()}))
            for i in range(problem.tau_arr.shape[0])]
    return dataclasses.replace(sols[0], **{k: torch.stack([getattr(s, k) for s in sols])
                                           for k in _tensor_fields(sols[0])})


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU")
    return device


def make_batched_problem(
    config: DisortConfig,
    tau_arr,            # (B, L)
    omega_arr,          # (B, L)
    leg_coeffs_all,     # (B, L, nleg_all)
    mu0,                # (B,)
    I0,                 # (B,)
    phi0=None,          # (B,) or None -> zeros
    f_arr=None,         # (B, L) or None -> zeros
    b_pos=None,         # (B, N, NF) or None -> zeros
    b_neg=None,
    s_poly_coeffs=None,  # (B, L, Ns) or None
    bdrf_modes=None,     # (B, NB, N, N) or None
    bdrf_modes_mu0=None,
    dtype=torch.float32,
    device=None,         # default "cuda"
) -> DisortProblem:
    """Assemble a batched problem (leading axis = batch) on ``device``.

    The beam's Legendre basis at ``-mu0`` is tabulated on the host here
    (``lam_mu0``, (B, NF, NLeg)), except for a mu0 tensor that requires a
    gradient or carries a forward-mode tangent: that mu0 becomes the
    problem's own, ``lam_mu0`` stays None, and the solve builds the table
    on the device from it, so d lam(-mu0) / d mu0 stays in the graph (the
    JAX package's route for a traced mu0).  A tensor argument is used as
    it is when its dtype and device match, so its graph reaches the solve
    (gradients w.r.t. omega, tau, mu0, ...).
    """
    device = _device(device)
    with span("disort.entry"):
        B, L = np.shape(tau_arr)
        N, NF = config.n, config.nfourier

        def _arr(x, shape=None):
            if x is None:
                return torch.zeros((B,) + shape, dtype=dtype, device=device)
            if isinstance(x, torch.Tensor) and (x.device.type != "cpu" or device.type == "cpu"):
                return x.to(dtype=dtype, device=device)      # no copy out of host memory
            with span("disort.entry.copy"):
                # copied in the host array's own dtype and converted on the device: a
                # conversion on the host runs in the CPU's thread pool, whose time
                # swings with the host's load
                t = x.to(device=device) if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x), device=device)
                return from_host(t).to(dtype)

        if isinstance(mu0, torch.Tensor) and (mu0.requires_grad or has_tangent(mu0)):
            lam_mu0 = None
        else:
            with span("disort.entry.legendre"):
                if isinstance(mu0, torch.Tensor):
                    if mu0.is_cuda:
                        count("host_syncs")
                    mu0_host = mu0.detach().cpu().double().numpy()
                else:
                    mu0_host = np.asarray(mu0, np.float64)
                lam_mu0 = _arr(np.transpose(normalized_assoc_legendre_host(NF, config.nleg, -mu0_host), (2, 0, 1)))

        return DisortProblem(
            config=config,
            tau_arr=_arr(tau_arr),
            omega_arr=_arr(omega_arr),
            leg_coeffs_all=_arr(leg_coeffs_all),
            f_arr=_arr(f_arr, (L,)),
            mu0=_arr(mu0),
            I0=_arr(I0),
            phi0=_arr(phi0, ()),
            b_pos=_arr(b_pos, (N, NF)),
            b_neg=_arr(b_neg, (N, NF)),
            s_poly_coeffs=_arr(s_poly_coeffs, (L, max(config.nscoeffs, 1))),
            bdrf_modes=_arr(bdrf_modes, (max(config.nbdrf, 1), N, N)),
            bdrf_modes_mu0=_arr(bdrf_modes_mu0, (max(config.nbdrf, 1), N)),
            lam_mu0=lam_mu0,
        )


def _on(like, x):
    """``x`` as a tensor of the dtype and device of ``like`` (a problem or a
    solution).  Probe depths and azimuths are best tensors there already:
    an array is copied over first, and that copy synchronizes the stream."""
    out = torch.as_tensor(x, dtype=like.tau_arr.dtype, device=like.tau_arr.device)
    return out if isinstance(x, torch.Tensor) and x.device.type != "cpu" else from_host(out)


def _with_gc(sol):
    if sol.GC is None:
        raise ValueError("intensity output needs a solution of a config with only_flux=False")
    return sol


def fluxes_at(sol, tau):
    """(flux_up, flux_down_diffuse, flux_down_direct), each (B, Ntau)."""
    tau = _on(sol, tau)
    with span("disort.eval.fluxes", tau.device):
        return ev.fluxes_all(sol, tau)


def u0_at(sol, tau):
    """Zeroth Fourier mode of the intensity: (B, 2N, Ntau)."""
    sol, tau = _with_gc(sol), _on(sol, tau)
    with span("disort.eval.modes", tau.device):
        return ev.u0(sol, tau)


def u_at(sol, tau, phi):
    """Full intensity: (B, 2N, Ntau, Nphi); ``tau`` (B, Ntau), ``phi`` (B, Nphi)."""
    sol, tau, phi = _with_gc(sol), _on(sol, tau), _on(sol, phi)
    with span("disort.eval.modes", tau.device):
        return ev.u(sol, tau, phi)


def u_corrected_at(sol, tau, phi):
    """Nakajima-Tanaka corrected intensity: (B, 2N, Ntau, Nphi).

    The reference's intensity output under ``NT_cor=True`` (reference
    ``pydisort.py:643-698``): `u_at` plus the TMS/IMS correction, both
    evaluated on the whole batch (``nt.u_corrected``'s sum).
    """
    sol, tau, phi = _with_gc(sol), _on(sol, tau), _on(sol, phi)
    with span("disort.eval.nt", tau.device):
        corr = sol.rescale_factor[:, None, None, None] * nt.nt_correction(sol, tau, phi)
    return u_at(sol, tau, phi) + corr


def solve_fluxes(problem: DisortProblem, tau_eval):
    """Batched solve + flux evaluation at ``tau_eval`` (B, Ntau), a tensor
    on the problem's device (see `_on`)."""
    _device(problem.tau_arr.device)
    return fluxes_at(solve_batched(problem), tau_eval)


def _check_probes_per_layer(tau_arr, tau_eval):
    """Raise ``ValueError`` unless probe ``t`` of every solve lies in layer
    ``t``: tau_eval (B, L) with tau_{t-1} < tau_eval[:, t] <= tau_t (the
    top of layer 0 included).  On the card: one reduction and one host
    read."""
    if tau_eval.shape != tau_arr.shape:
        raise ValueError(
            f"probes_per_layer needs one probe per layer: tau_eval {tuple(tau_eval.shape)}, "
            f"tau_arr {tuple(tau_arr.shape)}")
    tops = torch.cat([torch.zeros_like(tau_arr[:, :1]), tau_arr[:, :-1]], dim=1)
    above = tau_eval > tops
    above[:, 0] |= tau_eval[:, 0] == 0
    if tau_eval.is_cuda:
        count("host_syncs")
    if not bool((above & (tau_eval <= tau_arr)).all()):
        raise ValueError("probes_per_layer needs probe t inside layer t: tau_{t-1} < tau_eval[:, t] <= tau_t")


def solve_intensity(problem: DisortProblem, tau_eval, phi_eval, nt_correct=None, probes_per_layer=False):
    """Batched solve + full intensity: (B, 2N, Ntau, Nphi).

    ``nt_correct`` (default ``problem.config.nt_correct``) adds the
    Nakajima-Tanaka TMS/IMS corrections.  ``probes_per_layer``: ``tau_eval``
    holds one probe per layer, probe ``t`` inside layer ``t`` (checked,
    `_check_probes_per_layer`); the Fourier modes are then contracted inside
    the solve (`solve_batched_probes`) and ``GC`` is never built.
    Otherwise the solution needs ``only_flux=False``.
    """
    _device(problem.tau_arr.device)
    if nt_correct is None:
        nt_correct = problem.config.nt_correct
    tau_eval = _on(problem, tau_eval)
    phi_eval = _on(problem, phi_eval)
    if not probes_per_layer:
        sol = solve_batched(problem)
        return (u_corrected_at if nt_correct else u_at)(sol, tau_eval, phi_eval)
    _check_probes_per_layer(problem.tau_arr, tau_eval)
    sol, um = solve_batched_probes(problem, tau_eval)
    if nt_correct:
        with span("disort.eval.nt", um.device):
            corr = nt.nt_correction(sol, tau_eval, phi_eval)
    with span("disort.eval.modes", um.device):
        NF = problem.config.nfourier
        modes = torch.arange(NF, dtype=um.dtype, device=um.device)
        cos = torch.cos(modes[None, :, None] * (sol.phi0[:, None, None] - phi_eval[:, None, :]))   # (B, NF, Nphi)
        u = torch.einsum("smit,smp->sitp", um, cos)
        if nt_correct:
            u = u + corr
        return sol.rescale_factor[:, None, None, None] * u


def actinic_at(sol, tau):
    """Diffuse actinic fluxes ``(up, down)``, each (B, Ntau): ``2 pi W @ u0``
    per hemisphere, the delta-M reclassification of the direct beam added
    to the downward one (reference ``subroutines.py:258-318``)."""
    tau = _on(sol, tau)
    u0v = u0_at(sol, tau)                                     # (B, 2N, Ntau)
    N = sol.config.n
    up = 2.0 * math.pi * torch.einsum("si,sit->st", sol.W, u0v[:, :N])
    dn = 2.0 * math.pi * torch.einsum("si,sit->st", sol.W, u0v[:, N:])
    return up, dn + ev.act_dscale_reclassification(sol, tau)


def solve_actinic(problem: DisortProblem, tau_eval):
    """Batched solve + diffuse actinic fluxes at ``tau_eval`` (B, Ntau)."""
    _device(problem.tau_arr.device)
    return actinic_at(solve_batched(problem), tau_eval)


def _axes(mesh, axis_name) -> tuple:
    """``axis_name`` (one mesh axis or a tuple of them) as a tuple of names of ``mesh``."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for name in names:
        mesh.size(name)                                    # raises for an unknown axis
    return names


def _local_problem(problem, mesh, axis_name, *evals):
    """This rank's shard as one flat batch: ``(leading dims, problem,
    evaluation tensors)``, every leading dimension sharded over an axis of
    ``axis_name`` flattened into one.  Raises ``ValueError`` unless the
    problem and the evaluation tensors sit on the mesh's device."""
    nlead = len(_axes(mesh, axis_name))
    for x in (problem.tau_arr, *evals):
        if not isinstance(x, torch.Tensor) or x.device != mesh.device:
            where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
            raise ValueError(f"a sharded solve takes this rank's shard on {mesh.device} (`mesh.shard_batch`), "
                             f"got {where}")
    flat = lambda x: x.reshape((-1,) + x.shape[nlead:])
    lead = tuple(problem.tau_arr.shape[:nlead])
    local = dataclasses.replace(problem, **{k: flat(v) for k, v in _tensor_fields(problem).items()})
    return lead, local, [flat(x) for x in evals]


def solve_fluxes_sharded(problem: DisortProblem, tau_eval, mesh, axis_name=BATCH_AXIS):
    """`solve_fluxes` on this rank's shard of a batch sharded over ``mesh``.

    ``problem`` and ``tau_eval`` are this rank's rows (`mesh.shard_batch`),
    on the mesh's device.  ``axis_name`` is one mesh axis (one leading batch
    dimension) or a tuple of axes, e.g. ``("columns", "bands")`` for leaves
    with two leading batch dimensions; the shard is then solved as one flat
    batch and the fluxes take its leading shape again.  The solve issues no
    collective (`mesh.count_collectives` reads zero): each rank returns its
    own rows.  The counterpart of the JAX package's ``shard_map`` program.
    """
    lead, local, (tau,) = _local_problem(problem, mesh, axis_name, tau_eval)
    return tuple(x.reshape(lead + x.shape[1:]) for x in solve_fluxes(local, tau))


def solve_intensity_sharded(problem: DisortProblem, tau_eval, phi_eval, mesh, axis_name=BATCH_AXIS,
                            nt_correct=None, probes_per_layer=False):
    """`solve_intensity` on this rank's shard, as `solve_fluxes_sharded`
    solves fluxes: ``u`` of this rank's rows, no collective."""
    lead, local, (tau, phi) = _local_problem(problem, mesh, axis_name, tau_eval, phi_eval)
    u = solve_intensity(local, tau, phi, nt_correct=nt_correct, probes_per_layer=probes_per_layer)
    return u.reshape(lead + u.shape[1:])


def global_flux_stats(fup, axis_name=None, mesh=None):
    """The mean of ``fup``: over this rank's rows without ``axis_name``;
    over the ranks of one mesh axis or a tuple of them with it, by one
    ``all_reduce`` of (sum, count) on each axis's group (the JAX package's
    two ``psum``s).  A mesh without a group (world 1) reduces nothing."""
    total = torch.stack([fup.sum(), torch.full((), fup.numel(), dtype=fup.dtype, device=fup.device)])
    if axis_name is not None:
        if mesh is None:
            raise ValueError("global_flux_stats: a reduction over a mesh axis needs the mesh")
        for name in _axes(mesh, axis_name):
            group = mesh.group(name)
            if group is not None:
                torch.distributed.all_reduce(total, group=group)
    return total[0] / total[1]
