"""The port's resumable sweep driver held against the JAX package's (CPU, float64).

The counterpart of ``tests/test_parallel.py::test_sweep_driver_resume``:
``pythonic_disort_torch.parallel.SweepDriver`` over the same batch (B = 12 in
chunks of 5) gathers the fluxes of the JAX package's ``solve_fluxes``,
skips finished chunks, reruns exactly the chunks a manifest no longer
marks done, writes the same bits with and without overlap, and shares its
file format with the JAX driver: each finishes a directory the other
started.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from pythonic_disort_tpu import parallel as jpar

from pythonic_disort_torch import parallel as tpar
from test_parallel import _random_batch
from test_torch_solve_fluxes import to_port

B, CHUNK = 12, 5
FLUXES = ("flux_up", "flux_down_diffuse", "flux_down_direct")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    # six xdist workers share the machine
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def batch():
    """The JAX problem and depths, the port's, and JAX's fluxes of the whole batch."""
    _, problem, tau_eval = _random_batch(B)
    ref = [np.asarray(x) for x in jax.jit(jpar.solve_fluxes)(problem, tau_eval)]
    return problem, tau_eval, to_port(problem), torch.tensor(np.asarray(tau_eval)), dict(zip(FLUXES, ref))


def rows(problem, a, b):
    """Rows a:b of every tensor of a batched problem (views)."""
    return dataclasses.replace(problem, **{f.name: getattr(problem, f.name)[a:b]
                                           for f in dataclasses.fields(problem)
                                           if isinstance(getattr(problem, f.name), torch.Tensor)})


def port_run(out_dir, batch, overlap=True):
    _, _, port, tau, _ = batch
    driver = tpar.SweepDriver(str(out_dir), CHUNK, overlap=overlap)
    return driver, driver.run(lambda a, b: rows(port, a, b), lambda a, b: tau[a:b], B)


def jax_run(out_dir, batch, n_total=B):
    problem, tau_eval, _, _, _ = batch
    driver = jpar.SweepDriver(str(out_dir), CHUNK)
    return driver, driver.run(lambda a, b: jax.tree.map(lambda x: x[a:b], problem), lambda a, b: tau_eval[a:b],
                              n_total)


def assert_matches_jax(out, ref):
    for k in FLUXES:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-12, atol=1e-15, err_msg=k)


def test_sweep_driver_resume(tmp_path, batch):
    d1, t1 = port_run(tmp_path, batch)
    assert sorted(t1) == [0, 1, 2] and all(t > 0 for t in t1.values())
    d2, t2 = port_run(tmp_path, batch)
    assert t2 == {}
    out = d2.gather()
    assert out["flux_up"].shape == (B, 4)
    assert_matches_jax(out, batch[4])
    with open(os.path.join(tmp_path, "manifest.json")) as f:
        assert json.load(f) == {"chunks": {"0": "done", "1": "done", "2": "done"}}
    assert not os.path.exists(os.path.join(tmp_path, "manifest.json.tmp"))
    for ci in range(3):
        with np.load(os.path.join(tmp_path, f"chunk_{ci}.npz")) as z:
            assert sorted(z.files) == sorted(FLUXES + ("start", "stop"))
            assert (int(z["start"]), int(z["stop"])) == (ci * CHUNK, min((ci + 1) * CHUNK, B))


def test_partial_resume_reruns_only_the_dropped_chunks(tmp_path, batch):
    d1, _ = port_run(tmp_path, batch)
    before = d1.gather()
    manifest = os.path.join(tmp_path, "manifest.json")
    with open(manifest) as f:
        m = json.load(f)
    del m["chunks"]["1"]
    with open(manifest, "w") as f:
        json.dump(m, f)
    os.remove(os.path.join(tmp_path, "chunk_2.npz"))       # marked done, but its file is gone
    d2, t2 = port_run(tmp_path, batch)
    assert sorted(t2) == [1, 2]
    after = d2.gather()
    for k in FLUXES:
        assert np.array_equal(after[k], before[k]), k


def test_overlap_equals_no_overlap_bitwise(tmp_path, batch):
    outs = [port_run(tmp_path / str(overlap), batch, overlap=overlap)[0].gather() for overlap in (True, False)]
    for k in FLUXES:
        assert np.array_equal(outs[0][k], outs[1][k]), k
    assert_matches_jax(outs[1], batch[4])


def test_port_finishes_a_jax_directory(tmp_path, batch):
    """The JAX driver runs chunks 0 and 1 of 3; the port's driver runs only chunk 2."""
    _, tj = jax_run(tmp_path, batch, n_total=2 * CHUNK)
    assert sorted(tj) == [0, 1]
    driver, t = port_run(tmp_path, batch)
    assert sorted(t) == [2]
    out = driver.gather()
    assert_matches_jax(out, batch[4])
    ref = jpar.SweepDriver(str(tmp_path), CHUNK).gather()
    for k in FLUXES:
        assert np.array_equal(out[k], ref[k]), k


def test_jax_finishes_a_port_directory(tmp_path, batch):
    """The port's driver runs chunks 0 and 1; the JAX driver runs only chunk 2."""
    _, _, port, tau, _ = batch
    t = tpar.SweepDriver(str(tmp_path), CHUNK).run(lambda a, b: rows(port, a, b), lambda a, b: tau[a:b], 2 * CHUNK)
    assert sorted(t) == [0, 1]
    driver, tj = jax_run(tmp_path, batch)
    assert sorted(tj) == [2]
    assert_matches_jax(driver.gather(), batch[4])
