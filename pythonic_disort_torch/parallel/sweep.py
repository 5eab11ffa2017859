"""Chunked, resumable flux sweeps.

Counterpart of ``pythonic_disort_tpu/parallel/sweep.py``.  A sweep over a
large (columns x bands) batch is split into chunks; each chunk's fluxes
are written to ``<out_dir>/chunk_<i>.npz`` and a manifest records which
chunks are done.  A restart skips them.  The files are the JAX driver's,
so either package's driver can resume the other's directory, with or
without a mesh.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .batch import solve_fluxes, solve_fluxes_sharded
from .mesh import shard_batch

_FLUXES = ("flux_up", "flux_down_diffuse", "flux_down_direct")


class SweepDriver:
    """Run a chunked flux sweep with resumable output shards.

    The sweep runs on the device of the problems that ``problem_for_chunk``
    returns.  On the card, chunks are double-buffered (``overlap=True``):
    chunk ``k+1``'s solve is enqueued before chunk ``k`` is drained.  The
    drain of a chunk copies its fluxes into pinned host memory,
    ``non_blocking`` on a side stream that waits on an event recorded after
    the chunk's solve, and waits on the copy's own event before writing the
    file, so the host's file writing overlaps the next chunk's solve.  The
    flux tensors are held until that copy has completed, so the caching
    allocator cannot hand their memory to the next chunk while the side
    stream reads it.  ``overlap=False`` synchronizes after each chunk and
    drains it at once.

    ``mesh`` (`mesh.default_mesh`, one axis): every rank of the mesh
    constructs the driver and calls `run` with the same arguments.  Each
    chunk's rows split evenly over the ranks (`mesh.shard_batch`), so
    ``chunk_size`` and the last chunk must divide by the mesh's size
    (``ValueError`` otherwise; nothing is padded).  Each rank solves its
    rows with `batch.solve_fluxes_sharded`, double-buffered as above; the
    drain gathers the ranks' host copies to rank 0 as objects (gloo gathers
    no CUDA tensor), and rank 0 alone writes the files and the manifest.
    Every rank skips the chunks that rank 0's manifest and files mark
    done, broadcast at the start of `run`, and `run` returns on every rank
    once the directory is complete.
    """

    def __init__(self, out_dir, chunk_size, mesh=None, overlap=True):
        self.out_dir = out_dir
        self.chunk_size = int(chunk_size)
        self.mesh = mesh
        self.overlap = overlap
        self._side = {}                    # device -> the side stream of its copies
        self._group = None                 # the mesh axis's group; None: one rank, no collective
        if mesh is not None:
            if len(mesh.axis_names) != 1:
                raise ValueError(f"SweepDriver splits chunks over a 1-D mesh, got axes {mesh.axis_names}")
            if self.chunk_size % mesh.world:
                raise ValueError(f"SweepDriver: chunk_size {self.chunk_size} does not divide by the "
                                 f"{mesh.world} ranks of the mesh")
            self._group = mesh.groups[0]
        self._writer = self._group is None or dist.get_rank(self._group) == 0
        if self._writer:
            os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, "manifest.json")
        self.manifest = self._load_manifest() if self._writer else None

    def _load_manifest(self):
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                return json.load(f)
        return {"chunks": {}}

    def _save_manifest(self):
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f)
        os.replace(tmp, self.manifest_path)

    def _stage(self, outs):
        """Start the copy of a chunk's fluxes to the host: ``(host tensors,
        the copy's event or None)``.  On the card, pinned buffers filled on
        the side stream after the solve's event; on the CPU, the fluxes."""
        device = outs[0].device
        if device.type != "cuda":
            return outs, None
        solved = torch.cuda.Event()
        solved.record(torch.cuda.current_stream(device))
        side = self._side.get(device)
        if side is None:
            side = self._side[device] = torch.cuda.Stream(device)
        host = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in outs)
        side.wait_event(solved)
        with torch.cuda.stream(side):
            for h, x in zip(host, outs):
                h.copy_(x, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return host, copied

    def run(self, problem_for_chunk, tau_eval_for_chunk, n_total):
        """Sweep ``n_total`` batch elements.

        ``problem_for_chunk(start, stop)`` returns the batched problem for
        that half-open index range, and ``tau_eval_for_chunk(start, stop)``
        its evaluation depths.  Returns the wall time in seconds of each
        chunk run, keyed by chunk index, from its solve's enqueue to its
        file's write.  With ``overlap=True`` adjacent intervals overlap and
        do not add up to the sweep's time; with ``overlap=False`` they do.
        """
        times = {}
        n_chunks = (n_total + self.chunk_size - 1) // self.chunk_size
        if self.mesh is not None and (n_total - (n_chunks - 1) * self.chunk_size) % self.mesh.world:
            raise ValueError(f"SweepDriver: the last chunk of {n_total} solves does not divide by the "
                             f"{self.mesh.world} ranks of the mesh")
        finished = self._finished(n_chunks)
        # (ci, start, stop, fluxes, host, copied, t0): the tuple holds the
        # chunk's flux tensors until its drain has waited on the copy
        pending = None

        def drain(p):
            ci, start, stop, _, host, copied, t0 = p
            if copied is not None:
                copied.synchronize()
            host = [h.numpy() for h in host]
            if self._group is not None:
                shards = [None] * dist.get_world_size(self._group) if self._writer else None
                dist.gather_object(host, shards, group_dst=0, group=self._group)
                if self._writer:
                    host = [np.concatenate(x, axis=0) for x in zip(*shards)]
            if self._writer:
                np.savez(os.path.join(self.out_dir, f"chunk_{ci}.npz"),
                         **dict(zip(_FLUXES, host)), start=start, stop=stop)
                self.manifest["chunks"][str(ci)] = "done"
                self._save_manifest()
            times[ci] = time.perf_counter() - t0

        for ci in range(n_chunks):
            if ci in finished:
                continue
            start = ci * self.chunk_size
            stop = min(start + self.chunk_size, n_total)
            problem = problem_for_chunk(start, stop)
            tau_eval = tau_eval_for_chunk(start, stop)
            if self.mesh is not None:
                problem = shard_batch(problem, self.mesh)
                tau_eval = shard_batch(tau_eval, self.mesh)
            t0 = time.perf_counter()
            outs = (solve_fluxes(problem, tau_eval) if self.mesh is None
                    else solve_fluxes_sharded(problem, tau_eval, self.mesh))
            if self.overlap:
                staged = (ci, start, stop, outs, *self._stage(outs), t0)
                if pending is not None:
                    drain(pending)         # the host writes while the card solves chunk ci
                pending = staged
            else:
                if outs[0].device.type == "cuda":
                    torch.cuda.synchronize(outs[0].device)
                drain((ci, start, stop, outs, tuple(x.cpu() for x in outs), None, t0))
        if pending is not None:
            drain(pending)
        if self._group is not None:
            dist.barrier(group=self._group)        # rank 0 has written the last chunk
        return times

    def _finished(self, n_chunks) -> set:
        """The chunks rank 0's manifest marks done and whose files exist,
        broadcast to every rank of the mesh."""
        finished = [None]
        if self._writer:
            finished[0] = {ci for ci in range(n_chunks)
                           if self.manifest["chunks"].get(str(ci)) == "done"
                           and os.path.exists(os.path.join(self.out_dir, f"chunk_{ci}.npz"))}
        if self._group is not None:
            dist.broadcast_object_list(finished, group_src=0, group=self._group)
        return finished[0]

    def gather(self):
        """Concatenate all finished chunks in index order (with a mesh, on
        any rank that sees rank 0's directory)."""
        if not self._writer:
            self.manifest = self._load_manifest()
        outs = {k: [] for k in _FLUXES}
        for ci in sorted(int(k) for k, v in self.manifest["chunks"].items() if v == "done"):
            with np.load(os.path.join(self.out_dir, f"chunk_{ci}.npz")) as z:
                for k in outs:
                    outs[k].append(z[k])
        return {k: np.concatenate(v, axis=0) for k, v in outs.items() if v}
