"""The port's batched intensity path held against the JAX package (CPU, float64).

The batched solve with every feature (iso source, BDRF, delta-M, NFourier
> 1, intensity output), the batched entry points ``u0_at``, ``u_at``,
``u_corrected_at``, ``solve_intensity`` (general and one probe per layer)
and ``solve_actinic``, and the batched Nakajima-Tanaka correction.  Each
problem is built by the JAX package from numpy inputs made with a seed and
carried across with ``convert.problem_from_arrays``.  The eigenvector
columns come out in another order in the two packages, so only quantities
free of that order are compared (``B``, ``mathscr_b``, the flux tables,
fluxes, u, u0), to roundoff grown by the conditioning of the solve.
"""

import dataclasses
import functools
from math import pi

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar
from pythonic_disort_tpu.models.disort import eval as jev
from pythonic_disort_tpu.models.disort.batch_solve import solve_batched as jax_solve_batched

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort import eval as ev
from pythonic_disort_torch.models.disort import nt
from pythonic_disort_torch.models.disort.batch_solve import solve_batched, solve_batched_probes
from test_batch_solve import CASES, _problem
from test_torch_solve_fluxes import to_port


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def close(out, ref, rtol=1e-9, atol_rel=1e-12, label=""):
    """``out`` (tensor) against ``ref`` (JAX or numpy), elementwise with an
    absolute floor relative to the largest |ref|."""
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, label
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol_rel * np.abs(ref).max(), err_msg=label)


def _column_solution(port, i):
    """Row ``i`` of a batched problem through the single-column ``solve``."""
    return pt.solve(dataclasses.replace(port, **{
        f.name: getattr(port, f.name)[i] for f in dataclasses.fields(port)
        if f.name not in ("config", "lam_mu0")}, lam_mu0=None))


def azimuths(S, values):
    return np.broadcast_to(np.asarray(values, np.float64), (S, len(values))).copy()


# ------------------------------------------------- the solve's feature matrix
@pytest.mark.parametrize("nlayers,nfourier,beam,iso,bdrf,deltam,only_flux", CASES)
def test_batched_solve_matches_jax(nlayers, nfourier, beam, iso, bdrf, deltam, only_flux):
    """Every row of tests/test_batch_solve.py::CASES, iso and intensity rows
    included: the solution's order-free fields, fluxes at interior and
    boundary depths, and u where the config asks for intensities."""
    problem, tau = _problem(nlayers, nfourier, beam, iso, bdrf, deltam, only_flux)
    tau_eval = np.concatenate([tau * 0.5, tau, np.zeros((tau.shape[0], 1))], axis=1)
    phi = azimuths(tau.shape[0], np.linspace(0, 2 * np.pi, 3))

    @jax.jit
    def reference(problem, tau_eval, phi):
        sol = jax_solve_batched(problem)
        outs = {"fluxes": jax.vmap(jev.fluxes_all)(sol, tau_eval)}
        if not only_flux:
            outs.update(u=jax.vmap(jev.u)(sol, tau_eval, phi), u0=jax.vmap(jev.u0)(sol, tau_eval))
        return sol, outs

    ref, ref_out = reference(problem, jnp.asarray(tau_eval), jnp.asarray(phi))
    out = solve_batched(to_port(problem))
    assert out.G is None
    assert (out.GC is None) == only_flux
    for f in ("B", "mathscr_b", "fi_up", "fi_dn", "fb_up", "fb_dn", "scaled_tau_with_0", "scale_tau",
              "rescale_factor"):
        close(getattr(out, f), getattr(ref, f), label=f)
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref_out["fluxes"], pt.fluxes_at(out, tau_eval)):
        close(b, a, label=lbl)
    if not only_flux:
        close(pt.u_at(out, tau_eval, phi), ref_out["u"], label="u")
        close(pt.u0_at(out, tau_eval), ref_out["u0"], label="u0")


def test_flux_only_solution_refuses_intensity():
    problem, tau = _problem(*CASES[0])
    sol = solve_batched(to_port(problem))
    with pytest.raises(ValueError, match="only_flux=False"):
        pt.u0_at(sol, tau)
    with pytest.raises(ValueError, match="only_flux=False"):
        pt.solve_actinic(to_port(problem), tau)


# ------------------------------------------------- the batched entry points
def test_batched_intensity_and_actinic_match_jax():
    """The case of tests/test_parallel.py::test_batched_intensity_and_actinic_match_single,
    the port's batched entry points against the JAX package's, and against
    the port's single-column solve on two rows."""
    B = 6
    rng = np.random.default_rng(17)
    L, nquad = 3, 8
    tau = np.cumsum(rng.uniform(0.1, 1.0, (B, L)), axis=1)
    omega = rng.uniform(0.1, 0.9, (B, L))
    leg = np.zeros((B, L, nquad + 1))
    leg[..., 0] = 1
    leg[..., 2] = rng.uniform(0, 0.3, (B, L))
    config = pdt.DisortConfig(nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=nquad, nlayers=L,
                              nscoeffs=0, nbdrf=0, has_beam=True, only_flux=False, has_deltam=False)
    problem = jpar.make_batched_problem(config, tau, omega, leg, rng.uniform(0.3, 1.0, B), np.full(B, pi),
                                        dtype=jnp.float64)
    tau_eval = tau * (1 - 1e-12)
    phi_eval = azimuths(B, [0.0, 1.0, 3.0])
    tj, pj = jnp.asarray(tau_eval), jnp.asarray(phi_eval)

    port = to_port(problem)
    u = pt.solve_intensity(port, tau_eval, phi_eval)
    up, dn = pt.solve_actinic(port, tau_eval)
    sol = solve_batched(port)
    u0 = pt.u0_at(sol, tau_eval)
    assert u.shape == (B, nquad, L, 3)

    @jax.jit
    def reference(p, t, ph):
        sol = jpar.solve_batch(p)      # solve_intensity's and solve_actinic's solve
        return jpar.u_at(sol, t, ph), jpar.actinic_at(sol, t), jpar.u0_at(sol, t)

    u_ref, (up_ref, dn_ref), u0_ref = reference(problem, tj, pj)
    close(u, u_ref, rtol=1e-12, atol_rel=1e-14, label="u")
    close(up, up_ref, rtol=1e-12, atol_rel=1e-14, label="actinic up")
    close(dn, dn_ref, rtol=1e-12, atol_rel=1e-14, label="actinic down")
    close(u0, u0_ref, rtol=1e-12, atol_rel=1e-14, label="u0")

    W = sol.W[0].numpy()
    N = nquad // 2
    for i in (0, 4):
        single = _column_solution(port, i)
        t, p = torch.as_tensor(tau_eval[i]), torch.as_tensor(phi_eval[i])
        close(u[i], ev.u(single, t, p), rtol=1e-12, atol_rel=1e-14, label=f"u row {i}")
        u0v = ev.u0(single, t).numpy()
        close(u0[i], u0v, rtol=1e-12, atol_rel=1e-14, label=f"u0 row {i}")
        close(up[i], 2 * pi * W @ u0v[:N], rtol=1e-12, atol_rel=1e-14, label=f"actinic up row {i}")
        close(dn[i], 2 * pi * W @ u0v[N:], rtol=1e-12, atol_rel=1e-14, label=f"actinic down row {i}")


def _nt_problem(B, seed, omega_range=(0.5, 0.95), g_range=(0.6, 0.8)):
    """The configuration of tests/test_parallel.py::
    test_batched_nt_corrected_intensity_matches_single (delta-M beam, NT on)."""
    rng = np.random.default_rng(seed)
    L, nquad, nleg, nleg_all = 3, 8, 8, 32
    tau = np.cumsum(rng.uniform(0.2, 1.5, (B, L)), axis=1)
    omega = rng.uniform(*omega_range, (B, L))
    g = rng.uniform(*g_range, (B, L))
    leg = g[..., None] ** np.arange(nleg_all)[None, None, :]
    config = pdt.DisortConfig(nquad=nquad, nleg=nleg, nleg_all=nleg_all, nfourier=nquad, nlayers=L,
                              nscoeffs=0, nbdrf=0, has_beam=True, only_flux=False, has_deltam=True,
                              nt_correct=True)
    problem = jpar.make_batched_problem(config, tau, omega, leg, rng.uniform(0.4, 1.0, B), np.full(B, pi),
                                        f_arr=leg[..., nleg], dtype=jnp.float64)
    return problem, tau


def _single_corrected_u(port, i, tau, phi):
    """Row ``i`` through the port's single-column solve and its NT-corrected
    closure, ``make_corrected_u``."""
    return nt.make_corrected_u(_column_solution(port, i))(tau, phi)


def test_batched_nt_corrected_intensity_matches_jax():
    """The case of tests/test_parallel.py::test_batched_nt_corrected_intensity_matches_single:
    ``solve_intensity`` with the config's nt_correct against the JAX
    package's, and two rows against the single-column corrected closure."""
    B = 4
    problem, tau = _nt_problem(B, 23)
    tau_eval = tau * (1 - 1e-12)
    phi_eval = azimuths(B, [0.0, 0.7, 2.5])
    port = to_port(problem)
    u = pt.solve_intensity(port, tau_eval, phi_eval)
    u_raw = pt.u_at(solve_batched(port), tau_eval, phi_eval)
    assert u.shape == (B, 8, 3, 3)
    assert not np.allclose(u.numpy(), u_raw.numpy())
    ref = jax.jit(jpar.solve_intensity)(problem, jnp.asarray(tau_eval), jnp.asarray(phi_eval))
    close(u, ref, rtol=1e-10, atol_rel=1e-12, label="NT-corrected u")
    close(pt.u_corrected_at(solve_batched(port), tau_eval, phi_eval), ref, rtol=1e-10, atol_rel=1e-12,
          label="u_corrected_at")
    for i in (0, 3):
        close(u[i], _single_corrected_u(port, i, tau_eval[i], phi_eval[i]), rtol=1e-10, atol_rel=1e-12,
              label=f"row {i}")


def test_batched_nt_correction_is_per_column():
    """Columns of very different omega and f in one batch: the IMS averages
    and the TMS sums are per column, so each column's corrected u equals
    its single-column result (a batch-wide reduction would mix them)."""
    B = 4
    thin, _ = _nt_problem(2, 31, omega_range=(0.05, 0.15), g_range=(0.1, 0.2))
    thick, _ = _nt_problem(2, 32, omega_range=(0.97, 0.999), g_range=(0.85, 0.9))
    problem = jax.tree.map(lambda a, b: jnp.stack([a[0], b[0], a[1], b[1]]), thin, thick)
    port = to_port(problem)
    omega = port.omega_arr.numpy()
    assert omega[1::2].min() > 5 * omega[::2].max()
    tau = port.tau_arr.numpy()
    tau_eval = np.concatenate([tau * 0.4, tau * (1 - 1e-12)], axis=1)
    phi_eval = azimuths(B, [0.2, 1.9, 3.6])
    for probes in (False, True):
        te = tau_eval[:, 3:] if probes else tau_eval
        u = pt.solve_intensity(port, te, phi_eval, probes_per_layer=probes)
        for i in range(B):
            close(u[i], _single_corrected_u(port, i, te[i], phi_eval[i]), rtol=1e-10, atol_rel=1e-12,
                  label=f"column {i}, probes_per_layer={probes}")
    # the correction differs between the columns, so mixing would show
    corr = nt.nt_correction(solve_batched(port), torch.as_tensor(tau_eval), torch.as_tensor(phi_eval))
    scale = corr.abs().amax(dim=(1, 2, 3))
    assert scale[1::2].min() > 10 * scale[::2].max()


# ------------------------------------------------- one probe per layer
PROBE_CASES = [
    # (nlayers, nfourier, beam, iso, bdrf, deltam, nt_correct)
    (4, 4, True, False, True, True, False),
    (4, 4, True, False, True, True, True),
    (4, 4, True, True, False, True, False),
    (4, 4, True, True, False, True, True),
    (1, 4, True, True, True, True, False),
    (1, 4, True, True, True, True, True),
    (4, 1, False, True, False, False, False),
]


def _probe_inputs(case):
    problem, tau = _problem(*case, only_flux=False)
    return problem, tau * (1.0 - 1e-9), azimuths(tau.shape[0], [0.3, 1.7, 4.1])


@functools.lru_cache(maxsize=None)
def _jax_probe_path(case):
    """The JAX package's probe path on the problem of ``case``, NT off and
    on, from one compiled program (shared by the two parametrized tests)."""
    problem, tau_eval, phi_eval = _probe_inputs(case)
    nts = (False, True) if case[2] and case[5] else (False,)
    outs = jax.jit(lambda p, t, ph: [jpar.solve_intensity(p, t, ph, nt_correct=ntc, probes_per_layer=True)
                                     for ntc in nts])(problem, jnp.asarray(tau_eval), jnp.asarray(phi_eval))
    return dict(zip(nts, (np.asarray(u) for u in outs)))


@pytest.mark.parametrize("nlayers,nfourier,beam,iso,bdrf,deltam,ntc", PROBE_CASES)
def test_probe_path_matches_general_path_and_jax(nlayers, nfourier, beam, iso, bdrf, deltam, ntc):
    """The cases of tests/test_batch_solve.py::test_boundary_probe_intensity_matches_general_path,
    NT on and off: the port's probe path against its general path and
    against the JAX package's probe path."""
    case = (nlayers, nfourier, beam, iso, bdrf, deltam)
    problem, tau_eval, phi_eval = _probe_inputs(case)
    port = to_port(problem)
    fast = pt.solve_intensity(port, tau_eval, phi_eval, nt_correct=ntc, probes_per_layer=True)
    general = pt.solve_intensity(port, tau_eval, phi_eval, nt_correct=ntc)
    close(fast, general, rtol=1e-10, atol_rel=1e-12, label="probe path vs general path")
    close(fast, _jax_probe_path(case)[ntc], rtol=1e-10, atol_rel=1e-12, label="probe path vs JAX")


def test_probe_modes_and_solution():
    """``solve_batched_probes`` returns the solution without GC and the
    pre-rescale modes (S, NF, 2N, L) that `eval.u`'s synthesis sums."""
    problem, tau = _problem(4, 4, True, True, True, True, only_flux=False)
    port = to_port(problem)
    sol, um = solve_batched_probes(port, torch.as_tensor(tau * 0.999))
    assert sol.GC is None and um.shape == (3, 4, 8, 4)
    general = solve_batched(port)
    for f in ("B", "mathscr_b", "fvec_up", "fi_dn", "rescale_factor"):
        torch.testing.assert_close(getattr(sol, f), getattr(general, f), rtol=0, atol=0)
    # azimuth phi0 picks the sum of the modes
    u = pt.u_at(general, tau * 0.999, sol.phi0[:, None].numpy())
    close(sol.rescale_factor[:, None, None] * um.sum(dim=1), u[..., 0].numpy(), rtol=1e-10, atol_rel=1e-12)


def test_probe_at_top_of_atmosphere_is_accepted():
    """tau = 0 lies in layer 0 by the evaluators' rule, so it is a valid probe there."""
    problem, tau = _problem(4, 4, True, False, False, True, only_flux=False)
    tau_eval = tau.copy()
    tau_eval[:, 0] = 0.0
    phi_eval = azimuths(3, [0.5])
    port = to_port(problem)
    close(pt.solve_intensity(port, tau_eval, phi_eval, probes_per_layer=True),
          pt.solve_intensity(port, tau_eval, phi_eval).numpy(), rtol=1e-10, atol_rel=1e-12)


@pytest.mark.parametrize("where", ["one short", "above its layer", "below the bottom", "below its layer"])
def test_probe_precondition_refused(where):
    problem, tau = _problem(4, 4, True, False, False, True, only_flux=False)
    tops = np.concatenate([np.zeros((3, 1)), tau[:, :-1]], axis=1)
    tau_eval = {"one short": tau[:, :-1],
                "above its layer": np.where(np.arange(4) == 2, tops - 1e-3, tau),
                "below the bottom": np.where(np.arange(4) == 3, tau + 1e-3, tau),
                "below its layer": np.where(np.arange(4) == 1, tau + 1e-3, tau)}[where]
    with pytest.raises(ValueError, match="probes_per_layer"):
        pt.solve_intensity(to_port(problem), tau_eval, azimuths(3, [0.5]), probes_per_layer=True)
