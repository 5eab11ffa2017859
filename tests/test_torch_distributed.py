"""Several ranks of the port through ``torch.distributed`` (gloo, CPU),
held against the JAX package's sharded programs (float64).

Each launch starts the ranks of ``pythonic_disort_torch.tools.mesh_worker``
as processes of their own (``OMP_NUM_THREADS=1``, a free port on
127.0.0.1); the JAX references run here on conftest's eight fake devices.

- 2 ranks (the counterpart of ``tests/test_distributed.py``): the
  ``_distributed_worker.py`` problem (L = 4, NQuad = 8, B = 4 x world),
  each rank's rows against JAX's ``solve_fluxes`` at rtol 1e-12 and
  ``global_flux_stats`` over the mesh against JAX's mean; the sharded
  NT intensity of ``tests/test_parallel.py::test_sharded_intensity_on_mesh``;
  ``SweepDriver`` with the mesh against JAX's ``SweepDriver(mesh=
  default_mesh())``, each driver finishing a directory of the other's
  after two manifest entries are dropped;
- 4 ranks: ``__graft_entry__.py``'s rich configuration on a (2, 2)
  ``("columns", "bands")`` mesh, fluxes and NT intensity against JAX's
  ``solve_fluxes_sharded`` and ``solve_intensity_sharded`` on a (2, 2)
  mesh of four fake devices.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import pythonic_disort_tpu as pdt
from pythonic_disort_tpu import parallel as jpar

from pythonic_disort_torch.tools import mesh_worker
from __graft_entry__ import _example_batch

AXES = ("columns", "bands")
FLUXES = ("flux_up", "flux_down_diffuse", "flux_down_direct")
ZERO = dict.fromkeys(jpar.mesh.COLLECTIVE_OPS, 0)


def ranks_env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * max(np.abs(b).max(), 1e-300), err_msg=what)


def jax_problem(cfg, arrays):
    return jpar.make_batched_problem(pdt.DisortConfig(**cfg), dtype=jnp.float64, **arrays)


def drop_two(directory):
    path = os.path.join(directory, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    for ci in ("1", "2"):
        del manifest["chunks"][ci]
    with open(path, "w") as f:
        json.dump(manifest, f)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two ranks running the flux, intensity and sweep cases; the JAX
    driver's directory (two entries dropped) for them to finish, and the
    JAX driver's full result."""
    base = tmp_path_factory.mktemp("two_ranks")
    cfg, arrays, tau = mesh_worker.flux_arrays(mesh_worker.COARSE_B)
    problem, tau_eval = jax_problem(cfg, arrays), jnp.asarray(tau)
    jax_dir = str(base / "jax")
    driver = jpar.SweepDriver(jax_dir, mesh_worker.COARSE_CHUNK, mesh=jpar.default_mesh())
    driver.run(lambda a, b: jax.tree.map(lambda x: x[a:b], problem), lambda a, b: tau_eval[a:b],
               mesh_worker.COARSE_B)
    jax_sweep = driver.gather()
    drop_two(jax_dir)
    ranks = mesh_worker.run_ranks(2, ["flux", "intensity", "sweep"], base, env=ranks_env(),
                                  sweep_dir=base / "port", finish_dir=jax_dir)
    return ranks, base, jax_sweep, (problem, tau_eval)


def test_two_ranks_fluxes_match_jax(two_ranks):
    ranks = two_ranks[0]
    cfg, arrays, tau = mesh_worker.flux_arrays(8)
    ref = [np.asarray(x) for x in jax.jit(jpar.solve_fluxes)(jax_problem(cfg, arrays), jnp.asarray(tau))]
    for rank, (meta, arr) in enumerate(ranks):
        m = meta["flux"]
        assert meta["backend"] == "gloo" and meta["device"] == "cpu"
        (start, stop), = m["index"]
        assert (start, stop) == (4 * rank, 4 * rank + 4)
        for k, r in zip(("fup", "fdn", "fdir"), ref):
            close(arr[f"flux_{k}"], r[start:stop], f"rank {rank} {k}")
        assert m["counts"] == ZERO, m["counts"]
        assert m["stat_counts"] == {**ZERO, "all-reduce": 1}
        np.testing.assert_allclose(m["stat"], float(jnp.mean(ref[0])), rtol=1e-12)
        np.testing.assert_allclose(m["local_stat"], ref[0][start:stop].mean(), rtol=1e-12)
        assert m["odd_raises"]


def test_two_ranks_intensity_matches_jax(two_ranks):
    cfg, arrays, tau, phi = mesh_worker.intensity_arrays()
    jmesh = jpar.default_mesh()
    ref = np.asarray(jax.jit(lambda p, t, f: jpar.solve_intensity_sharded(p, t, f, jmesh))(
        jpar.shard_batch(jax_problem(cfg, arrays), jmesh), jpar.shard_batch(jnp.asarray(tau), jmesh),
        jpar.shard_batch(jnp.asarray(phi), jmesh)))
    for rank, (meta, arr) in enumerate(two_ranks[0]):
        (start, stop), = meta["intensity"]["index"]
        assert (start, stop) == (4 * rank, 4 * rank + 4)
        close(arr["intensity_u"], ref[start:stop], f"rank {rank} u")
        assert meta["intensity"]["counts"] == ZERO


def test_two_ranks_sweep_matches_jax_and_each_finishes_the_other(two_ranks):
    ranks, base, jax_sweep, (problem, tau_eval) = two_ranks
    for meta, _ in ranks:
        m = meta["sweep"]
        assert m["ran"] == [0, 1, 2, 3] and m["finished"] == [1, 2]
        assert m["chunk_raises"] and m["last_raises"]
    port_dir = str(base / "port")
    port = jpar.SweepDriver(port_dir, mesh_worker.COARSE_CHUNK).gather()
    finished_jax = jpar.SweepDriver(str(base / "jax"), mesh_worker.COARSE_CHUNK).gather()
    for k in FLUXES:
        assert port[k].shape == (mesh_worker.COARSE_B, 4)
        close(port[k], jax_sweep[k], f"the port's sweep, {k}")
        close(finished_jax[k], jax_sweep[k], f"the JAX directory the port finished, {k}")
    # the JAX driver on a mesh finishes the port's directory
    drop_two(port_dir)
    driver = jpar.SweepDriver(port_dir, mesh_worker.COARSE_CHUNK, mesh=jpar.default_mesh())
    ran = driver.run(lambda a, b: jax.tree.map(lambda x: x[a:b], problem), lambda a, b: tau_eval[a:b],
                     mesh_worker.COARSE_B)
    assert sorted(ran) == [1, 2]
    got = driver.gather()
    for k in FLUXES:
        close(got[k], jax_sweep[k], f"the port's directory JAX finished, {k}")
        assert np.array_equal(got[k][:8], port[k][:8]) and np.array_equal(got[k][24:], port[k][24:]), k


def test_four_ranks_rich_config_on_a_2d_mesh_matches_jax(tmp_path):
    cfg, arrays, tau, phi = mesh_worker.rich_arrays()
    _, jprob, jtau = _example_batch(4, 3, 8, nbands=4, dtype=jnp.float64, rich=True)
    np.testing.assert_array_equal(np.asarray(jtau), tau)
    for name in ("s_poly_coeffs", "f_arr", "mu0", "omega_arr"):
        np.testing.assert_array_equal(np.asarray(getattr(jprob, name)).reshape(arrays[name].shape), arrays[name])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), AXES)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P(*AXES)))
    jprob = jax.tree.map(put, jprob)
    jtau, jphi = put(jtau), put(jnp.asarray(phi))
    ref = [np.asarray(x) for x in jax.jit(lambda p, t: jpar.solve_fluxes_sharded(p, t, mesh, axis_name=AXES))(
        jprob, jtau)]
    ref_u = np.asarray(jax.jit(lambda p, t, f: jpar.solve_intensity_sharded(
        p, t, f, mesh, axis_name=AXES, nt_correct=True))(jprob, jtau, jphi))

    ranks = mesh_worker.run_ranks(4, ["rich"], tmp_path, env=ranks_env())
    seen = set()
    for rank, (meta, arr) in enumerate(ranks):
        m = meta["rich"]
        assert m["coords"] == [rank // 2, rank % 2]
        idx = tuple(slice(a, b) for a, b in m["index"])
        seen.add((idx[0].start, idx[1].start))
        for k, r in zip(("fup", "fdn", "fdir"), ref):
            close(arr[f"rich_{k}"], r[idx], f"rank {rank} {k}")
        close(arr["rich_u"], ref_u[idx], f"rank {rank} u")
        assert m["counts"] == ZERO and m["u_counts"] == ZERO
        assert m["stat_counts"] == {**ZERO, "all-reduce": 2}          # one an axis
        np.testing.assert_allclose(m["stat"], ref[0].mean(), rtol=1e-12)
    assert seen == {(0, 0), (0, 2), (2, 0), (2, 2)}
