"""The port's mesh and sharded entries in one process, held against the
JAX package (CPU, float64).

Without an initialized process group ``parallel.default_mesh`` is this
process's one device, and the sharded entries solve the whole batch; a
one-rank gloo group gives the collectives something to count.  The
counterparts of ``tests/test_parallel.py::test_sharded_solve_on_mesh``
(the spec and the statistic), ``::test_sharded_production_program_is_collective_free``
and ``::test_sharded_intensity_on_mesh``, whose JAX side runs on
conftest's eight fake devices; ``shard_batch``'s ``ValueError`` on an
indivisible batch; ``solve_vmapped`` and ``solve_batch`` against the JAX
package's; the refusals of ``initialize_distributed`` and
``default_mesh`` without a card; ``SweepDriver`` on a one-rank mesh.
``tests/test_torch_distributed.py`` runs several ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar
from pythonic_disort_tpu.parallel.batch import solve_vmapped as jax_solve_vmapped

import pythonic_disort_torch as pt
from pythonic_disort_torch import parallel as par
from pythonic_disort_torch.parallel import batch as tbatch
from pythonic_disort_torch.parallel.mesh import Mesh
from pythonic_disort_torch.tools import mesh_worker
from test_batch_solve import CASES, _problem
from test_parallel import _random_batch
from test_torch_solve_fluxes import to_port

FLUXES = ("flux_up", "flux_down_diffuse", "flux_down_direct")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def one_rank_group():
    """A gloo process group of this process alone, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{mesh_worker.free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_solve_on_mesh():
    mesh = par.default_mesh(devices="cpu")
    assert (mesh.world, mesh.device, mesh.groups) == (1, torch.device("cpu"), (None,))
    _, problem, tau_eval = _random_batch(16)
    jmesh = jpar.default_mesh()
    jfup = jax.jit(jpar.solve_fluxes)(jpar.shard_batch(problem, jmesh), jpar.shard_batch(tau_eval, jmesh))[0]
    assert par.batch_sharding(mesh).spec == tuple(jfup.sharding.spec) == ("batch",)

    port, tau = to_port(problem), torch.tensor(np.asarray(tau_eval))
    local, tau_s = par.shard_batch(port, mesh), par.shard_batch(tau, mesh)
    assert local.tau_arr is port.tau_arr or local.tau_arr.data_ptr() == port.tau_arr.data_ptr()
    outs = par.solve_fluxes_sharded(local, tau_s, mesh)
    for a, b in zip(outs, par.solve_fluxes(port, tau)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jfup), rtol=1e-12, atol=1e-12)
    # the cross-batch statistic, without and over the mesh axis (world 1)
    jstat = float(jpar.global_flux_stats(jfup))
    for stat in (par.global_flux_stats(outs[0]), par.global_flux_stats(outs[0], "batch", mesh)):
        np.testing.assert_allclose(stat.item(), jstat, rtol=1e-12)


def test_sharded_program_is_collective_free(one_rank_group):
    """count_collectives reads zero for the sharded solves and one
    all-reduce for the statistic over the mesh axis; JAX's kinds."""
    mesh = par.default_mesh(devices="cpu")
    assert mesh.groups == (dist.group.WORLD,)
    _, problem, tau_eval = _random_batch(8)
    port, tau = to_port(problem), torch.tensor(np.asarray(tau_eval))
    outs, counts = par.count_collectives(par.solve_fluxes_sharded, par.shard_batch(port, mesh), tau, mesh)
    assert list(counts) == list(jpar.mesh.COLLECTIVE_OPS)
    assert all(v == 0 for v in counts.values()), counts
    stat, counts = par.count_collectives(par.global_flux_stats, outs[0], "batch", mesh)
    assert counts == {**dict.fromkeys(counts, 0), "all-reduce": 1}
    np.testing.assert_allclose(stat.item(), outs[0].mean().item(), rtol=1e-14)
    _, counts = par.count_collectives(dist.broadcast, torch.zeros(2), 0)
    assert counts["collective-permute"] == 1


def test_sharded_intensity_on_mesh():
    cfg, arrays, tau, phi = mesh_worker.intensity_arrays()
    jmesh = jpar.default_mesh()
    jprob = jpar.make_batched_problem(pdt.DisortConfig(**cfg), dtype=jnp.float64, **arrays)
    ref = jax.jit(lambda p, t, f: jpar.solve_intensity_sharded(p, t, f, jmesh))(
        jpar.shard_batch(jprob, jmesh), jpar.shard_batch(jnp.asarray(tau), jmesh),
        jpar.shard_batch(jnp.asarray(phi), jmesh))
    mesh = par.default_mesh(devices="cpu")
    problem = mesh_worker.problem_of(cfg, arrays, torch.float64, "cpu")
    u, counts = par.count_collectives(par.solve_intensity_sharded, par.shard_batch(problem, mesh),
                                      par.shard_batch(tau, mesh), par.shard_batch(phi, mesh), mesh)
    assert all(v == 0 for v in counts.values())
    np.testing.assert_allclose(u.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_shard_batch_takes_this_ranks_rows_or_raises():
    """Rank 3 of an 8-rank axis takes rows 6:8 of 16 and 3:4 of 8 x 8;
    12 rows do not divide by 8, in either package."""
    rank3 = Mesh(torch.device("cpu"), ("batch",), (8,), (3,), (None,))
    _, problem, _ = _random_batch(16)
    local = par.shard_batch(to_port(problem), rank3)
    assert dataclasses.asdict(local.config) == dataclasses.asdict(problem.config) and local.tau_arr.shape == (2, 4)
    np.testing.assert_array_equal(local.mu0.numpy(), np.asarray(problem.mu0)[6:8])
    assert par.shard_batch(np.arange(64.0).reshape(8, 8), rank3).tolist() == [list(range(24, 32))]
    with pytest.raises(ValueError, match="does not divide"):
        par.shard_batch(torch.zeros(12, 3), rank3)
    with pytest.raises(ValueError):
        jpar.shard_batch(jnp.zeros((12, 3)), jpar.default_mesh())
    grid = Mesh(torch.device("cpu"), ("columns", "bands"), (2, 4), (1, 2), (None, None))
    assert par.batch_sharding(grid, ("columns", "bands")).index((4, 8, 5)) == (slice(2, 4), slice(4, 6))
    with pytest.raises(ValueError, match="does not divide"):
        par.shard_batch(torch.zeros(4, 6, 5), grid, ("columns", "bands"))


@pytest.mark.parametrize("case", [CASES[0], CASES[5], CASES[6]])
def test_solve_vmapped_and_solve_batch_match_jax(case):
    """Fluxes (and u where the config keeps intensities) of each batched
    solution, the port's against the JAX package's, rtol 1e-10."""
    problem, tau = _problem(*case)
    port, tau_t = to_port(problem), torch.tensor(np.asarray(tau))
    assert par.solve_batch is pt.solve_batched
    phi = np.broadcast_to(np.array([0.3, 2.0]), (tau.shape[0], 2))
    for port_solve, jax_solve in ((tbatch.solve_vmapped, jax_solve_vmapped), (par.solve_batch, jpar.solve_batch)):
        sol, jsol = port_solve(port), jax.jit(jax_solve)(problem)
        for a, b in zip(par.fluxes_at(sol, tau_t), jpar.fluxes_at(jsol, jnp.asarray(tau))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12 * np.abs(b).max())
        if not problem.config.only_flux:
            ref = np.asarray(jpar.u_at(jsol, jnp.asarray(tau), jnp.asarray(phi)))
            np.testing.assert_allclose(par.u_at(sol, tau_t, torch.tensor(phi)).numpy(), ref,
                                       rtol=1e-10, atol=1e-12 * np.abs(ref).max())
    sol = tbatch.solve_vmapped(port)
    assert sol.K.shape[0] == sol.G.shape[0] == tau.shape[0]


@pytest.mark.parametrize("call, exc", [
    (lambda: par.initialize_distributed("127.0.0.1:1", 2, 0), RuntimeError),           # cuda, no card
    (lambda: par.initialize_distributed("127.0.0.1:1", 2, 0, device="cpu", backend="nccl"), ValueError),
    (lambda: par.initialize_distributed("127.0.0.1:1", 2, None, device="cpu"), ValueError),
    (lambda: par.default_mesh(), RuntimeError),                                          # cuda, no card
    (lambda: par.make_mesh((2, 1), ("columns", "bands"), "cpu"), ValueError),           # world 1
])
def test_refusals_without_a_card_or_a_group(call, exc):
    assert not torch.cuda.is_available() and not dist.is_initialized()
    with pytest.raises(exc):
        call()
    assert not dist.is_initialized()


def test_sweep_driver_on_a_one_rank_mesh(tmp_path):
    """The same files as without a mesh, bit for bit; a mesh of two axes
    is refused."""
    _, problem, tau_eval = _random_batch(12)
    port, tau = to_port(problem), torch.tensor(np.asarray(tau_eval))
    rows = lambda a, b: mesh_worker.problem_rows(port, a, b)
    mesh = par.default_mesh(devices="cpu")
    got = []
    for name, m in (("mesh", mesh), ("none", None)):
        driver = par.SweepDriver(str(tmp_path / name), 5, mesh=m)
        assert sorted(driver.run(rows, lambda a, b: tau[a:b], 12)) == [0, 1, 2]
        got.append(driver.gather())
    for k in FLUXES:
        assert np.array_equal(got[0][k], got[1][k]), k
    grid = Mesh(torch.device("cpu"), ("columns", "bands"), (1, 1), (0, 0), (None, None))
    with pytest.raises(ValueError, match="1-D"):
        par.SweepDriver(str(tmp_path / "grid"), 5, mesh=grid)
