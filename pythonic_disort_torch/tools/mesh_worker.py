"""One rank of a run over several devices (``torch.distributed``).

    python3 -m pythonic_disort_torch.tools.mesh_worker COORDINATOR NPROCS RANK \\
        --device cpu --backend gloo --cases flux,intensity --out rank0.npz

Start one process per rank with the same arguments but RANK.  Each rank
joins the default group (`parallel.initialize_distributed`), builds each
case's problem in full from a numpy seed, takes its own rows
(`parallel.shard_batch`) and runs the sharded entries on them, each under
`parallel.count_collectives`.  It writes its rows, their global index and
its readings to ``--out`` (an ``.npz``; the readings as JSON under
``meta``), destroys the process group and prints ``OK``.  The CPU tests
and ``chip_smoke.py`` start the ranks with `run_ranks` and hold the files
against unsharded solves.

Cases (float64 unless named ``bench``):

- ``flux``: ``tests/_distributed_worker.py``'s problem (L = 4, NQuad = 8,
  B = 4 x world) on a 1-D mesh: fluxes, ``global_flux_stats`` over the
  mesh and of the rank's rows, and ``shard_batch``'s ``ValueError`` on a
  batch of 4 x world + 1 rows;
- ``intensity``: ``tests/test_parallel.py::test_sharded_intensity_on_mesh``'s
  problem (B = 8, L = 3, NQuad = 8, NFourier = 4, delta-M, NT) on a 1-D
  mesh: the NT-corrected intensity;
- ``rich``: ``__graft_entry__.py``'s rich batch (4 columns x 4 bands, L = 3,
  NQuad = 8, delta-M, beam, iso source, BDRF, NFourier = 4) on a (2, 2)
  ``("columns", "bands")`` mesh: fluxes and the NT-corrected intensity;
- ``sweep``: ``SweepDriver`` with the mesh over `flux_arrays` (B = 32) in
  chunks of 8 into ``--sweep-dir``, then the driver finishing
  ``--finish-dir`` (a directory another driver started), and the
  ``ValueError`` of a chunk size and of a last chunk that do not divide by
  the mesh;
- ``bench``: ``bench.py``'s flux sweep (16 columns x 128 bands, L = 64,
  NQuad = 32, delta-M beam, float32), 1024 solves a rank on two ranks:
  kernel launches, ms (best of 3), ``global_flux_stats`` and the rank's
  first `REF_ROWS` rows in float64 on the CPU;
- ``bench_intensity``: ``bench.py:117-177``'s intensity chunk (2 columns x
  128 bands, NFourier = 16, NT corrections, float32, one probe a layer)
  on a (world, 1) ``("columns", "bands")`` mesh;
- ``bench_sweep``: ``SweepDriver`` with the mesh over the first 4.5 chunks
  (4608 solves) of `SWEEP_COLS` columns of ``bench.py``'s arrays into
  ``--sweep-dir`` (timed, launches counted), then a resume after two
  manifest entries are dropped (its collectives counted).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from math import pi
from pathlib import Path

import numpy as np
import torch

REF_ROWS = 256              # rows of a bench rank held against float64 on the CPU
INT_NFOURIER, INT_PHI = 16, (0.0, 1.6, 3.1, 4.7)
SWEEP_COLS, SWEEP_CHUNK, SWEEP_TOTAL, SWEEP_DROPPED = 132, 1024, 4608, (1, 3)
COARSE_CHUNK, COARSE_B = 8, 32          # the float64 sweep case


# ------------------------------------------------------------------ cases
def flux_config():
    return dict(nquad=8, nleg=8, nleg_all=9, nfourier=1, nlayers=4, nscoeffs=0, nbdrf=0, has_beam=True,
                only_flux=True, has_deltam=False)


def flux_arrays(B):
    """``tests/_distributed_worker.py``'s draws: (config, arrays, tau_eval)."""
    rng = np.random.default_rng(0)
    L, nquad = 4, 8
    tau = np.cumsum(rng.uniform(0.1, 0.5, (B, L)), axis=1)
    omega = rng.uniform(0.2, 0.8, (B, L))
    leg = np.zeros((B, L, nquad + 1))
    leg[..., 0] = 1
    mu0 = rng.uniform(0.3, 1.0, B)
    return flux_config(), dict(tau_arr=tau, omega_arr=omega, leg_coeffs_all=leg, mu0=mu0,
                               I0=np.full(B, pi)), tau


def intensity_arrays():
    """``tests/test_parallel.py::test_sharded_intensity_on_mesh``'s draws:
    (config, arrays, tau_eval, phi_eval)."""
    B, L, nquad = 8, 3, 8
    rng = np.random.default_rng(4)
    tau = np.cumsum(rng.uniform(0.1, 1.0, (B, L)), axis=1)
    omega = rng.uniform(0.3, 0.9, (B, L))
    g = rng.uniform(0.4, 0.7, (B, L))
    leg = g[..., None] ** np.arange(nquad + 1)[None, None, :]
    cfg = dict(nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=4, nlayers=L, nscoeffs=0, nbdrf=0,
               has_beam=True, only_flux=False, has_deltam=True, nt_correct=True)
    arrays = dict(tau_arr=tau, omega_arr=omega, leg_coeffs_all=leg, mu0=rng.uniform(0.4, 1, B),
                  I0=np.full(B, pi), f_arr=leg[..., nquad])
    return cfg, arrays, tau * (1 - 1e-9), np.broadcast_to(np.array([0.2, 2.1]), (B, 2)).copy()


def rich_arrays(ncols=4, nbands=4, L=3, nquad=8):
    """``__graft_entry__._example_batch(ncols, L, nquad, nbands, rich=True)``'s
    draws, flat over (columns x bands): (config, arrays, tau_eval (ncols,
    nbands, L), phi_eval (ncols, nbands, 2))."""
    rng = np.random.default_rng(0)
    shape, Bflat, N = (ncols, nbands), ncols * nbands, nquad // 2
    tau = np.cumsum(rng.uniform(0.1, 1.0, shape + (L,)), axis=-1)
    omega = rng.uniform(0.1, 0.9, shape + (L,))
    leg = np.zeros(shape + (L, nquad + 1))
    leg[..., 0] = 1
    leg[..., 2] = rng.uniform(0, 0.3, shape + (L,))
    mu0 = rng.uniform(0.3, 1.0, shape)
    f_arr = rng.uniform(0.0, 0.2, shape + (L,))
    cfg = dict(nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=4, nlayers=L, nscoeffs=3, nbdrf=1,
               has_beam=True, only_flux=False, has_deltam=True)
    arrays = dict(tau_arr=tau.reshape(Bflat, L), omega_arr=omega.reshape(Bflat, L),
                  leg_coeffs_all=leg.reshape(Bflat, L, nquad + 1), mu0=mu0.reshape(-1), I0=np.full(Bflat, pi),
                  f_arr=f_arr.reshape(Bflat, L), s_poly_coeffs=rng.uniform(0, 0.5, (Bflat, L, 3)),
                  bdrf_modes=np.full((Bflat, 1, N, N), 0.3), bdrf_modes_mu0=np.full((Bflat, 1, N), 0.3))
    phi = np.broadcast_to(np.array([0.4, 2.2]), shape + (2,)).copy()
    return cfg, arrays, tau, phi


def intensity_problem(arrs, dtype, device, nfourier=INT_NFOURIER, phi=INT_PHI):
    """``bench.py:117-177``'s intensity configuration (NQuad = 32, NFourier =
    16, delta-M beam, NT corrections) of ``bench_arrays``-style arrays, with
    its probes, tau (1 - 1e-6) at each layer's bottom, and four azimuths:
    (problem, tau_eval, phi_eval)."""
    import pythonic_disort_torch as pt

    nquad = arrs["leg"].shape[-1] - 1
    cfg = pt.DisortConfig(
        nquad=nquad, nleg=nquad, nleg_all=nquad + 1, nfourier=nfourier, nlayers=arrs["tau"].shape[1],
        nscoeffs=0, nbdrf=0, has_beam=True, only_flux=False, has_deltam=True, nt_correct=True)
    prob = pt.make_batched_problem(cfg, arrs["tau"], arrs["omega"], arrs["leg"], arrs["mu0"], arrs["I0"],
                                   f_arr=arrs["f_arr"], dtype=dtype, device=device)
    S = arrs["tau"].shape[0]
    phis = torch.tensor(phi, dtype=dtype, device=device).expand(S, len(phi)).contiguous()
    return prob, prob.tau_arr * (1 - 1e-6), phis


def problem_of(cfg, arrays, dtype, device):
    import pythonic_disort_torch as pt

    return pt.make_batched_problem(pt.DisortConfig(**cfg), dtype=dtype, device=device, **arrays)


def lead_shape(problem, lead):
    """Every tensor of a flat batched problem with its batch axis as ``lead``."""
    return dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name).reshape(lead + getattr(problem, f.name).shape[1:])
        for f in dataclasses.fields(problem) if isinstance(getattr(problem, f.name), torch.Tensor)})


def problem_rows(problem, a, b):
    """Rows a:b of every tensor of a batched problem (views)."""
    return dataclasses.replace(problem, **{f.name: getattr(problem, f.name)[a:b]
                                           for f in dataclasses.fields(problem)
                                           if isinstance(getattr(problem, f.name), torch.Tensor)})


# ------------------------------------------------------------------ the rank
class Rank:
    """What one rank writes: arrays and JSON readings, by case."""

    def __init__(self, mesh, device):
        self.mesh, self.device, self.arrays, self.meta = mesh, device, {}, {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def index(self, shape, axis_name):
        from pythonic_disort_torch.parallel import batch_sharding

        return [[s.start, s.stop] for s in batch_sharding(self.mesh, axis_name).index(shape)]

    def best_ms(self, run, reps=3):
        times = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            run()
            self.sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return min(times)


def launches():
    """The launch counts of kernels 1, 2 and 3 (`profiling.recorded`)."""
    from pythonic_disort_torch.utils import profiling

    counts = profiling.recorded()["launches"]
    return {k: counts.get(k, 0) for k in ("eig_stage", "bvp_fused_wide", "blocktri")}


def counted_launches(r, run):
    """``run()`` with the launch counts read before and after: (result, launches)."""
    before = launches()
    out = run()
    r.sync()
    return out, {k: v - before[k] for k, v in launches().items()}


def case_flux(r, world):
    from pythonic_disort_torch import parallel as par

    cfg, arrays, tau = flux_arrays(4 * world)
    problem = par.shard_batch(problem_of(cfg, arrays, torch.float64, "cpu"), r.mesh)
    tau_s = par.shard_batch(tau, r.mesh)
    outs, counts = par.count_collectives(par.solve_fluxes_sharded, problem, tau_s, r.mesh)
    stat, stat_counts = par.count_collectives(par.global_flux_stats, outs[0], "batch", r.mesh)
    for k, x in zip(("fup", "fdn", "fdir"), outs):
        r.arrays[f"flux_{k}"] = x.cpu().numpy()
    try:
        par.shard_batch(np.zeros((4 * world + 1, 3)), r.mesh)
        odd_raises = False
    except ValueError:
        odd_raises = True
    r.meta["flux"] = dict(index=r.index(tau.shape, "batch"), counts=counts, stat_counts=stat_counts,
                          stat=stat.item(), local_stat=par.global_flux_stats(outs[0]).item(), odd_raises=odd_raises)


def case_intensity(r, world):
    from pythonic_disort_torch import parallel as par

    cfg, arrays, tau, phi = intensity_arrays()
    problem = par.shard_batch(problem_of(cfg, arrays, torch.float64, "cpu"), r.mesh)
    u, counts = par.count_collectives(par.solve_intensity_sharded, problem, par.shard_batch(tau, r.mesh),
                                      par.shard_batch(phi, r.mesh), r.mesh)
    r.arrays["intensity_u"] = u.cpu().numpy()
    r.meta["intensity"] = dict(index=r.index(tau.shape, "batch"), counts=counts)


def case_rich(r, world):
    from pythonic_disort_torch import parallel as par

    axes = ("columns", "bands")
    mesh = par.make_mesh((2, 2), axes, r.device.type)
    cfg, arrays, tau, phi = rich_arrays()
    problem = par.shard_batch(lead_shape(problem_of(cfg, arrays, torch.float64, "cpu"), tau.shape[:2]), mesh, axes)
    tau_s, phi_s = par.shard_batch(tau, mesh, axes), par.shard_batch(phi, mesh, axes)
    outs, counts = par.count_collectives(par.solve_fluxes_sharded, problem, tau_s, mesh, axes)
    u, u_counts = par.count_collectives(par.solve_intensity_sharded, problem, tau_s, phi_s, mesh, axes,
                                        nt_correct=True)
    stat, stat_counts = par.count_collectives(par.global_flux_stats, outs[0], axes, mesh)
    for k, x in zip(("fup", "fdn", "fdir"), outs):
        r.arrays[f"rich_{k}"] = x.cpu().numpy()
    r.arrays["rich_u"] = u.cpu().numpy()
    r.meta["rich"] = dict(index=[[s.start, s.stop] for s in par.batch_sharding(mesh, axes).index(tau.shape)],
                          coords=list(mesh.coords), counts=counts, u_counts=u_counts, stat=stat.item(),
                          stat_counts=stat_counts)


def raises_value_error(run):
    try:
        run()
    except ValueError:
        return True
    return False


def case_sweep(r, world, sweep_dir, finish_dir):
    from pythonic_disort_torch import parallel as par

    cfg, arrays, tau = flux_arrays(COARSE_B)
    problem, tau_t = problem_of(cfg, arrays, torch.float64, "cpu"), torch.from_numpy(tau)
    part, depths = (lambda a, b: problem_rows(problem, a, b)), (lambda a, b: tau_t[a:b])
    ran = par.SweepDriver(sweep_dir, COARSE_CHUNK, mesh=r.mesh).run(part, depths, COARSE_B)
    finished = par.SweepDriver(finish_dir, COARSE_CHUNK, mesh=r.mesh).run(part, depths, COARSE_B)
    bad_dir = os.path.join(sweep_dir, "never")
    r.meta["sweep"] = dict(
        ran=sorted(ran), finished=sorted(finished),
        chunk_raises=raises_value_error(lambda: par.SweepDriver(bad_dir, COARSE_CHUNK + 1, mesh=r.mesh)),
        last_raises=raises_value_error(
            lambda: par.SweepDriver(bad_dir, COARSE_CHUNK, mesh=r.mesh).run(part, depths, COARSE_B + 1)))


def case_bench(r, world):
    from pythonic_disort_torch import parallel as par
    from pythonic_disort_torch.tools.check_bvp import batched_problem, bench_arrays

    arrs = bench_arrays(16)
    full = batched_problem(arrs, 32, torch.float32, r.device)
    problem, tau = par.shard_batch(full, r.mesh), par.shard_batch(full.tau_arr, r.mesh)
    (outs, counts), launched = counted_launches(
        r, lambda: par.count_collectives(par.solve_fluxes_sharded, problem, tau, r.mesh))
    ms = r.best_ms(lambda: par.solve_fluxes_sharded(problem, tau, r.mesh))
    stat, stat_counts = par.count_collectives(par.global_flux_stats, outs[0], "batch", r.mesh)
    for k, x in zip(("fup", "fdn", "fdir"), outs):
        r.arrays[f"bench_{k}"] = x.cpu().numpy()
    (start, stop), = r.index(full.tau_arr.shape, "batch")
    t0 = time.perf_counter()
    ref = batched_problem({k: v[start:start + REF_ROWS] for k, v in arrs.items()}, 32, torch.float64, "cpu")
    for k, x in zip(("fup", "fdn", "fdir"), par.solve_fluxes(ref, ref.tau_arr)):
        r.arrays[f"bench_ref_{k}"] = x.numpy()
    r.meta["bench"] = dict(index=[[start, stop]], counts=counts, launches=launched, ms=ms, stat=stat.item(),
                           stat_device=str(outs[0].device), stat_counts=stat_counts,
                           ref_s=time.perf_counter() - t0)


def case_bench_intensity(r, world):
    from pythonic_disort_torch import parallel as par
    from pythonic_disort_torch.tools.check_bvp import bench_arrays

    axes = ("columns", "bands")
    mesh = par.make_mesh((world, 1), axes, r.device.type)
    full, tau, phi = intensity_problem(bench_arrays(2, seed=7), torch.float32, r.device)
    lead = (2, tau.shape[0] // 2)
    full = lead_shape(full, lead)
    problem = par.shard_batch(full, mesh, axes)
    tau_s = par.shard_batch(tau.reshape(lead + tau.shape[1:]), mesh, axes)
    phi_s = par.shard_batch(phi.reshape(lead + phi.shape[1:]), mesh, axes)
    run = lambda: par.solve_intensity_sharded(problem, tau_s, phi_s, mesh, axes, probes_per_layer=True)
    (u, counts), launched = counted_launches(r, lambda: par.count_collectives(run))
    ms = r.best_ms(run)
    r.arrays["bench_intensity_u"] = u.cpu().numpy()
    r.meta["bench_intensity"] = dict(
        index=[[s.start, s.stop] for s in par.batch_sharding(mesh, axes).index(lead)], coords=list(mesh.coords),
        counts=counts, launches=launched, ms=ms)


def case_bench_sweep(r, world, sweep_dir):
    import torch.distributed as dist
    from pythonic_disort_torch import parallel as par
    from pythonic_disort_torch.tools.check_bvp import batched_problem, bench_arrays

    problem = batched_problem(bench_arrays(SWEEP_COLS), 32, torch.float32, r.device)
    part, depths = (lambda a, b: problem_rows(problem, a, b)), (lambda a, b: problem.tau_arr[a:b])
    driver = par.SweepDriver(sweep_dir, SWEEP_CHUNK, mesh=r.mesh)
    r.sync()
    t0 = time.perf_counter()
    ran, launched = counted_launches(r, lambda: driver.run(part, depths, SWEEP_TOTAL))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    before = driver.gather() if r.mesh.coords[0] == 0 else None
    if r.mesh.coords[0] == 0:
        path = Path(sweep_dir) / "manifest.json"
        manifest = json.loads(path.read_text())
        for ci in SWEEP_DROPPED:
            del manifest["chunks"][str(ci)]
        path.write_text(json.dumps(manifest))
    dist.barrier()
    resumed = par.SweepDriver(sweep_dir, SWEEP_CHUNK, mesh=r.mesh)
    rerun, counts = par.count_collectives(resumed.run, part, depths, SWEEP_TOTAL)
    equal = None
    if before is not None:
        after = resumed.gather()
        equal = all(np.array_equal(after[k], before[k]) for k in before)
    r.meta["bench_sweep"] = dict(ran=sorted(ran), wall_ms=wall_ms, launches=launched, counts=counts,
                                 resumed=sorted(rerun), resume_equal=equal)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(nprocs, cases, out_dir, device="cpu", backend="gloo", timeout=240, env=None, **dirs):
    """Start ``nprocs`` ranks of this worker on this host and wait for them.

    ``dirs``: ``sweep_dir``, ``finish_dir``.  Returns each rank's
    ``(readings, arrays)`` from its ``.npz`` under ``out_dir``.  Raises
    ``RuntimeError`` with the rank's output if a rank fails, does not print
    ``OK`` or is still running after ``timeout`` seconds; every rank still
    running then is killed by its own process id.
    """
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ if env is None else env)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    outs = [Path(out_dir) / f"rank{rank}.npz" for rank in range(nprocs)]
    extra = [x for k, v in dirs.items() if v is not None for x in (f"--{k.replace('_', '-')}", str(v))]
    procs, results = [], []
    try:
        for rank in range(nprocs):
            cmd = [sys.executable, "-m", "pythonic_disort_torch.tools.mesh_worker", coordinator, str(nprocs),
                   str(rank), "--device", device, "--backend", backend, "--cases", ",".join(cases),
                   "--out", str(outs[rank]), *extra]
            procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                out, err = "", f"timed out after {timeout} s"
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (rc, out, err) in enumerate(results):
        if rc != 0 or "OK" not in out:
            raise RuntimeError(f"rank {rank} of {nprocs} failed (exit code {rc}):\n{out}\n{err[-4000:]}")
    loaded = []
    for path in outs:
        with np.load(path) as z:
            loaded.append((json.loads(str(z["meta"])), {k: z[k] for k in z.files if k != "meta"}))
    return loaded


CASES = dict(flux=case_flux, intensity=case_intensity, rich=case_rich, sweep=case_sweep, bench=case_bench,
             bench_intensity=case_bench_intensity, bench_sweep=case_bench_sweep)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("coordinator", help="host:port of rank 0's store")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--cases", required=True, help="comma-separated: " + ", ".join(CASES))
    ap.add_argument("--out", required=True, help="the .npz this rank writes")
    ap.add_argument("--sweep-dir", help="the directory of the sweep cases")
    ap.add_argument("--finish-dir", help="a sweep directory another driver started (case sweep)")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        ap.error(f"unknown cases {unknown}")

    import torch.distributed as dist
    import pythonic_disort_torch  # noqa: F401  (full-precision float32 products)
    from pythonic_disort_torch import parallel as par

    par.initialize_distributed(args.coordinator, args.nprocs, args.rank, backend=args.backend, device=args.device)
    try:
        mesh = par.default_mesh(args.device)
        r = Rank(mesh, mesh.device)
        r.meta["backend"] = dist.get_backend()
        r.meta["device"] = str(mesh.device)
        extra = dict(sweep=(args.sweep_dir, args.finish_dir), bench_sweep=(args.sweep_dir,))
        for case in cases:
            t0 = time.perf_counter()
            CASES[case](r, args.nprocs, *extra.get(case, ()))
            r.meta.setdefault(case, {})["seconds"] = time.perf_counter() - t0
        np.savez(args.out, meta=np.array(json.dumps(r.meta)), **r.arrays)
    finally:
        dist.destroy_process_group()
    print(f"rank {args.rank} of {args.nprocs} on {r.meta['device']} ({r.meta['backend']}): OK", flush=True)


if __name__ == "__main__":
    main()
