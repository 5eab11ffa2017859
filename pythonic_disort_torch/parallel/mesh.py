"""Meshes of ranks and batch sharding for column x band sweeps.

Counterpart of ``pythonic_disort_tpu/parallel/mesh.py`` in PyTorch's
idiom: one process (rank) per device, and ``torch.distributed`` between
the processes.  The batch axis of a sweep is embarrassingly parallel, so
each rank takes its own rows of every leading batch dimension
(`shard_batch`) and solves them with no collective; only cross-batch
diagnostics (`batch.global_flux_stats`) reduce over a mesh axis.

A `Mesh` is what one rank knows of the layout: its device, the axis names
and sizes, its coordinate on each axis and the process group of each
axis.  `default_mesh` lays the ranks of the default group on one axis;
`make_mesh` lays them on several (``("columns", "bands")``) over
``torch.distributed.device_mesh.init_device_mesh``, which gives each axis
its own group.  Without an initialized group the mesh is this process's
one device: world 1, and no collective anywhere.

Ranks that share one card use the ``gloo`` backend: NCCL refuses two
ranks on one device, and `initialize_distributed` raises rather than
switch backends.  Gloo reduces CUDA tensors but gathers only CPU tensors
(`sweep.SweepDriver` gathers host copies as objects).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXIS = "batch"


def _rank_device(device) -> torch.device:
    """``device`` ("cuda" by default, or "cpu") as this rank's device: CUDA
    ranks take the current card, and raise when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"a rank runs on 'cuda' or 'cpu', got {device}")
    return device


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, backend=None,
                           device=None):
    """Join this process to the default process group (no-op if it has joined).

    The JAX package's names: ``coordinator_address`` ("host:port") becomes
    ``init_method="tcp://host:port"`` with ``world_size=num_processes`` and
    ``rank=process_id``; with all three None the group comes from the
    environment (``env://``, as ``torchrun`` sets it).  ``device`` is where
    this rank computes, ``"cuda"`` (the default) or ``"cpu"``; a CUDA rank
    takes card ``local rank % device_count`` (``LOCAL_RANK`` where a
    launcher sets it, else ``process_id``), set before any CUDA tensor
    exists.  ``backend`` defaults to ``"nccl"`` for CUDA ranks and
    ``"gloo"`` for CPU ranks; ranks that share a card pass ``"gloo"``.
    Raises for NCCL on the CPU, for NCCL when this host has more ranks
    (``LOCAL_WORLD_SIZE``, else ``num_processes``) than cards, and for a
    CUDA rank without a card.
    """
    if dist.is_initialized():
        return
    env = coordinator_address is None
    if env != (num_processes is None) or env != (process_id is None):
        raise ValueError("initialize_distributed: give coordinator_address, num_processes and process_id "
                         "together, or none of them (env://)")
    world = int(os.environ["WORLD_SIZE"]) if env else int(num_processes)
    rank = int(os.environ["RANK"]) if env else int(process_id)
    kind = torch.device("cuda" if device is None else device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: a CUDA rank needs a card; pass device='cpu' for CPU ranks")
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > cards:
            raise ValueError(f"initialize_distributed: NCCL cannot place {local_world} ranks on {cards} card(s) "
                             "(two ranks on one device); pass backend='gloo'")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
    elif backend == "nccl":
        raise ValueError("initialize_distributed: NCCL needs CUDA ranks; CPU ranks use backend='gloo'")
    if env:
        dist.init_process_group(backend=backend, init_method="env://")
    else:
        address = coordinator_address.removeprefix("tcp://")
        dist.init_process_group(backend=backend, init_method=f"tcp://{address}", world_size=world, rank=rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh of ranks: its ``device``, the mesh's
    ``axis_names`` and ``shape``, its ``coords`` on each axis, and each
    axis's process group (``groups``, None without an initialized group:
    world 1, no collective)."""

    device: torch.device
    axis_names: tuple
    shape: tuple
    coords: tuple
    groups: tuple

    def _axis(self, name) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes are {self.axis_names}, got {name!r}")
        return self.axis_names.index(name)

    def size(self, name) -> int:
        """The number of ranks along axis ``name``."""
        return self.shape[self._axis(name)]

    def coord(self, name) -> int:
        """This rank's coordinate on axis ``name``."""
        return self.coords[self._axis(name)]

    def group(self, name):
        """The process group of axis ``name`` that holds this rank (None: no collective)."""
        return self.groups[self._axis(name)]

    @property
    def world(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A mesh of the default group's ranks, laid out row-major on
    ``shape`` with one name per axis.  ``devices``: "cuda" (the default:
    the rank's card) or "cpu".  A 1-D mesh uses the default group; more
    axes are built by ``init_device_mesh``, each axis with its own group.
    Without an initialized group only a mesh of one rank exists."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"make_mesh: {len(shape)} sizes for axes {axis_names}")
    device = _rank_device(devices)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh: a {shape} mesh needs {math.prod(shape)} ranks, the group has {world}")
    if not dist.is_initialized():
        return Mesh(device, axis_names, shape, (0,) * len(shape), (None,) * len(shape))
    if len(shape) == 1:
        return Mesh(device, axis_names, shape, (dist.get_rank(),), (dist.group.WORLD,))
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, shape, mesh_dim_names=axis_names)
    return Mesh(device, axis_names, shape, tuple(dm.get_coordinate()),
                tuple(dm.get_group(name) for name in axis_names))


def default_mesh(devices=None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over the default group's ranks (world 1 without a group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world,), (axis_name,), devices)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This rank's placement of batched tensors: leading dimension ``d``
    is split over mesh axis ``spec[d]`` (JAX's ``PartitionSpec``)."""

    mesh: Mesh
    spec: tuple

    def index(self, shape) -> tuple:
        """The global slices of this rank's rows in a tensor of ``shape``
        (the counterpart of ``addressable_shards[i].index``).  Raises
        ``ValueError`` when a leading dimension does not divide by its
        axis."""
        if len(shape) < len(self.spec):
            raise ValueError(f"a tensor of shape {tuple(shape)} has fewer than {len(self.spec)} batch dimensions")
        out = []
        for d, name in enumerate(self.spec):
            n, parts = shape[d], self.mesh.size(name)
            if n % parts:
                raise ValueError(f"batch dimension {d} of size {n} does not divide by the {parts} ranks "
                                 f"of mesh axis {name!r}")
            rows = n // parts
            c = self.mesh.coord(name)
            out.append(slice(c * rows, (c + 1) * rows))
        return tuple(out)


def batch_sharding(mesh: Mesh, axis_name=BATCH_AXIS) -> BatchSharding:
    """Sharding that splits leading (batch) dimensions over the mesh: one
    axis name splits the first, a tuple of names one dimension each."""
    return BatchSharding(mesh, (axis_name,) if isinstance(axis_name, str) else tuple(axis_name))


def shard_batch(tree, mesh: Mesh, axis_name=BATCH_AXIS):
    """This rank's rows of every tensor or numpy leaf of ``tree`` (a
    dataclass such as a ``DisortProblem``, or one tensor or array), on
    this rank's device.  Other fields (``config``, None) pass through.  A
    tensor already on the device gives a view where its rows are
    contiguous; only the rows are copied otherwise.  Raises ``ValueError``
    when a leading dimension does not divide by its mesh axis."""
    sharding = batch_sharding(mesh, axis_name)

    def local(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor):
            return x
        return x[sharding.index(x.shape)].to(mesh.device)

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: local(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return local(tree)


COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "all-to-all",
    "collective-permute", "reduce-scatter",
)

# the c10d operators of torch.distributed, by the JAX kind they count as:
# reductions as all-reduce, gathers as all-gather, and data sent from one
# rank to others (broadcast, scatter, send and receive) as collective-permute;
# a barrier moves no data and is not counted
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "reduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "gather_": "all-gather",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "scatter_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
}


def count_collectives(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), counts)``: the collectives the call issues,
    per JAX kind (`COLLECTIVE_OPS`).

    The counterpart of ``count_hlo_collectives``.  The port compiles no
    program, so there is no HLO to read: the call runs once under
    ``torch.profiler`` (host activity only) and every ``c10d::`` operator
    in the trace is counted, one per collective whatever the backend
    (gloo, NCCL).  The sharded solves (`batch.solve_fluxes_sharded`,
    `batch.solve_intensity_sharded`) issue none by design: a count above
    zero there is a regression.
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn(*args, **kwargs)
    counts = dict.fromkeys(COLLECTIVE_OPS, 0)
    for e in prof.events():
        if e.name.startswith("c10d::") and e.name != "c10d::barrier":
            kind = _C10D_KINDS.get(e.name.removeprefix("c10d::"))
            if kind is None:
                raise RuntimeError(f"count_collectives: {e.name} has no kind in COLLECTIVE_OPS")
            counts[kind] += 1
    return result, counts
