"""The port's batched flux solve held against the JAX package (CPU, float64).

Each problem is built by the JAX package's ``make_batched_problem`` from
numpy inputs made with a seed, carried across with
``convert.problem_from_arrays``, and solved by both packages'
``solve_fluxes``.  On CPU tensors the port runs the plain versions of its
two kernels; the JAX package runs its plain jnp paths.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pythonic_disort_tpu import DisortConfig as JaxConfig
from pythonic_disort_tpu.ops import legendre as jleg, quadrature as jquad
from pythonic_disort_tpu.parallel import make_batched_problem as jax_make_problem
from pythonic_disort_tpu.parallel import solve_fluxes as jax_solve_fluxes

import pythonic_disort_torch as pt
from pythonic_disort_torch.models.disort.batch_solve import solve_batched
from pythonic_disort_torch.ops import legendre, quadrature
from test_batch_solve import CASES, _problem

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def to_port(problem):
    """The JAX problem's config and leaves -> the port's problem (CPU, f64)."""
    leaves = {f.name: None if getattr(problem, f.name) is None else np.asarray(getattr(problem, f.name))
              for f in dataclasses.fields(problem) if f.name != "config"}
    return pt.problem_from_arrays(dataclasses.asdict(problem.config), leaves, "cpu", torch.float64)


def assert_fluxes_match(problem, tau_eval):
    ref = [np.asarray(x) for x in jax.jit(jax_solve_fluxes)(problem, jnp.asarray(tau_eval))]
    out = [x.numpy() for x in pt.solve_fluxes(to_port(problem), tau_eval)]
    # f64 on both sides; the eigen columns may come out in another order
    # and the BVP coefficients adapt, so agreement is
    # to roundoff grown by the BVP's conditioning, well inside 1e-9.
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref, out):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12 * np.abs(a).max(), err_msg=lbl)


FLUX_CASES = [
    CASES[0],                                    # headline: flux, delta-M beam
    CASES[1],                                    # no delta-M
    CASES[2],                                    # single layer
    (4, 1, True, False, True, True, True),       # BDRF surface, flux only
    (3, 2, True, False, True, True, True),       # BDRF, two Fourier modes
]


@pytest.mark.parametrize("nlayers,nfourier,beam,iso,bdrf,deltam,only_flux", FLUX_CASES)
def test_solve_fluxes_matches_jax(nlayers, nfourier, beam, iso, bdrf, deltam, only_flux):
    problem, tau = _problem(nlayers, nfourier, beam, iso, bdrf, deltam, only_flux)
    tau_eval = np.concatenate([tau * 0.5, tau, np.zeros((tau.shape[0], 1))], axis=1)
    assert_fluxes_match(problem, tau_eval)


def test_solve_fluxes_matches_jax_bench_shape():
    """The bench configuration (NQuad=32, 64 layers, delta-M beam) on 2 bands."""
    rng = np.random.default_rng(42)
    S, L, NQ = 2, 64, 32
    tau = np.cumsum(rng.uniform(0.05, 0.5, (S, L)), axis=1)
    omega = rng.uniform(0.3, 0.99, (S, L))
    g = rng.uniform(0.5, 0.85, (S, L))
    leg = g[..., None] ** np.arange(NQ + 1)[None, None, :]
    cfg = JaxConfig(nquad=NQ, nleg=NQ, nleg_all=NQ + 1, nfourier=1, nlayers=L, nscoeffs=0,
                    nbdrf=0, has_beam=True, only_flux=True, has_deltam=True)
    problem = jax_make_problem(cfg, tau, omega, leg, rng.uniform(0.2, 1.0, S), np.full(S, np.pi),
                               f_arr=leg[..., NQ], dtype=jnp.float64)
    assert_fluxes_match(problem, tau)


def test_solve_fluxes_matches_jax_nquad48():
    """NQuad = 48: the batched solve hands the boundary-value operands to
    `solve_bvp_fused`, which launches kernel 7's capacity NC = 48 on the
    card (on CPU tensors, its plain version)."""
    problem, tau = _problem(3, 1, True, False, False, True, True, S=2, nquad=48, seed=3)
    assert_fluxes_match(problem, tau)


def test_solution_fields_match_jax():
    """Fields that do not depend on the eigen column order."""
    from pythonic_disort_tpu.models.disort.batch_solve import solve_batched as jax_solve_batched

    problem, _ = _problem(*CASES[0])
    ref = jax.jit(jax_solve_batched)(problem)
    out = solve_batched(to_port(problem))
    assert out.G is None and out.GC is None
    np.testing.assert_allclose(np.sort(out.K.numpy(), -1), np.sort(np.asarray(ref.K), -1), rtol=1e-10)
    for f in ("B", "fb_up", "fb_dn", "scaled_tau_with_0", "scale_tau", "rescale_factor",
              "I0", "scaled_omega_arr", "weighted_leg_all", "weighted_scaled_leg"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-9, atol=1e-13, err_msg=f)


@pytest.mark.parametrize("deltam", [True, False])
def test_flux_antiderivative_matches_jax(deltam):
    from pythonic_disort_tpu.models.disort import eval as jax_eval
    from pythonic_disort_tpu.models.disort.batch_solve import solve_batched as jax_solve_batched
    from pythonic_disort_torch.models.disort import eval as port_eval

    problem, tau = _problem(4, 1, True, False, False, deltam, True)
    tau_eval = np.concatenate([tau * 0.3, tau], axis=1)
    sol = jax.jit(jax_solve_batched)(problem)
    ref = jax.vmap(lambda s, t: jax_eval.fluxes_all(s, t, True))(sol, jnp.asarray(tau_eval))
    out = port_eval.fluxes_all(solve_batched(to_port(problem)), torch.as_tensor(tau_eval), True)
    for lbl, a, b in zip(("fup", "fdn", "fdir"), ref, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-9, atol=1e-12 * np.abs(a).max(), err_msg=lbl)


def test_make_batched_problem_matches_jax_field_by_field():
    problem, tau = _problem(*FLUX_CASES[3])
    cfg = dataclasses.asdict(problem.config)
    port = pt.make_batched_problem(
        pt.DisortConfig(**cfg), tau, np.asarray(problem.omega_arr), np.asarray(problem.leg_coeffs_all),
        np.asarray(problem.mu0), np.asarray(problem.I0), phi0=np.asarray(problem.phi0),
        f_arr=np.asarray(problem.f_arr), bdrf_modes=np.asarray(problem.bdrf_modes),
        bdrf_modes_mu0=np.asarray(problem.bdrf_modes_mu0), dtype=torch.float64, device="cpu")
    for f in dataclasses.fields(problem):
        if f.name == "config":
            assert dataclasses.asdict(port.config) == cfg
            continue
        np.testing.assert_array_equal(getattr(port, f.name).numpy(), np.asarray(getattr(problem, f.name)),
                                      err_msg=f.name)


def test_entry_points_refuse_to_run_on_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem, tau = _problem(*CASES[0])
    args = (pt.DisortConfig(**dataclasses.asdict(problem.config)), tau,
            np.asarray(problem.omega_arr), np.asarray(problem.leg_coeffs_all),
            np.asarray(problem.mu0), np.asarray(problem.I0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.make_batched_problem(*args)
    assert pt.make_batched_problem(*args, device="cpu").tau_arr.device.type == "cpu"


def test_host_tables_match_jax():
    for nquad in (4, 16, 32):
        for a, b in zip(quadrature.double_gauss(nquad), jquad.double_gauss(nquad)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(quadrature.clenshaw_curtis(9), jquad.clenshaw_curtis(9)):
        np.testing.assert_array_equal(a, b)
    x = np.linspace(-1, 1, 11)
    np.testing.assert_array_equal(legendre.normalized_assoc_legendre_host(4, 9, x),
                                  jleg.normalized_assoc_legendre_host(4, 9, x))


def test_config_tables_are_built_once():
    """A second solve of one configuration builds no host table (on the card
    each table build is a copy that synchronizes the stream)."""
    from pythonic_disort_torch.models.disort import batch_solve

    port = to_port(_problem(*FLUX_CASES[4])[0])
    solve_batched(port)
    built = batch_solve._tables.cache_info().misses
    again = solve_batched(port)
    assert batch_solve._tables.cache_info().misses == built
    tab = batch_solve._tables(4, 4, 5, 2, torch.float64, torch.device("cpu"))
    np.testing.assert_array_equal(tab.mu.numpy(), quadrature.double_gauss(4)[0])
    np.testing.assert_array_equal(tab.parity.numpy(), [[1, -1, 1, -1], [0, 1, -1, 1]])
    np.testing.assert_array_equal(tab.bdrf_delta.numpy(), [2, 1])
    assert torch.isfinite(again.fvec_up).all()


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "pythonic_disort_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pythonic_disort_tpu"), f"{path}: imports {mod}"
