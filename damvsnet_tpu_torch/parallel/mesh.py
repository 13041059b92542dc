"""Process groups across ranks; counterpart of damvsnet_tpu/parallel/mesh.py.

The JAX package lays its devices out as a ('data', 'space') mesh and lets
GSPMD insert the collectives. Here every rank is a process that owns one
device, and the collectives are explicit:

  * "data": batch parallelism. Each rank takes its rows of the global batch
    (``batch_rows``); DDP averages the gradients over the data group, and
    training-mode BatchNorm and the losses reduce their statistics over it
    (``nn/blocks.py::batch_stats_group``, ``losses/``).
  * "space": the ranks of a space group hold the same samples. The
    depth-slab axis (``parallel/slab.py``, JAX's ``slab_constraint``): each
    rank holds one slab of every cost volume's depth hypotheses and runs
    CostRegNet on it, with halo exchanges between neighbours; its
    BatchNorms take their statistics over every rank of the mesh
    (``Mesh.slab_stats_group``). FMT's sequence parallelism
    (``parallel/fmt_sp.py``) splits a sample's tokens over such a group.

Ranks are laid out data-major, as JAX reshapes its devices to (data,
space): rank = d * space + s. A launcher such as ``torchrun`` sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT; without them
everything runs in one process, with no process group.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one (``"cpu"``, or a
    CUDA device with its index), else ``cuda:{LOCAL_RANK % device_count}``.
    Raises without CUDA unless the CPU is named (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def maybe_initialize_distributed(backend: str | None = None, device=None,
                                 timeout: float | None = None):
    """Join the process group that torchrun's environment describes and
    return ``(rank, world)``.

    * A process group already exists: nothing is done.
    * WORLD_SIZE is unset: one process, ``(0, 1)``, no process group.
    * Otherwise ``init_process_group`` over ``env://`` (RANK, WORLD_SIZE,
      MASTER_ADDR, MASTER_PORT) with ``backend``: by default ``nccl`` on
      CUDA and ``gloo`` on the CPU (``device`` as ``local_device`` reads
      it). A rendezvous that fails or outlasts ``timeout`` seconds raises;
      nothing carries on in one process.

    NCCL puts at most one rank on a card: ranks that share one run ``gloo``
    (its collectives take CUDA tensors through the host)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def shard_work_items(items, process_index: int | None = None,
                     process_count: int | None = None):
    """Scan-parallel work items (SURVEY §2.7): rank i takes items[i::n]."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    return list(items)[process_index::process_count]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, space) mesh. ``data_group``: the
    ranks of this rank's space index (a column: DDP, BatchNorm and the
    losses reduce over it); ``space_group``: the ranks of this rank's data
    index (a row: the depth slabs); ``slab_stats_group``: every rank, over
    which a slab region's BatchNorm takes its statistics (the global batch
    and the whole depth axis). A group is None where it would hold one
    rank: there is nothing to reduce over."""
    data: int = 1
    space: int = 1
    data_rank: int = 0
    data_group: object = None
    space_group: object = None
    space_rank: int = 0
    slab_stats_group: object = None


def make_mesh(data: int | None = None, space: int = 1) -> Mesh:
    """The (data, space) mesh over every rank of the process group (one
    rank without one). data defaults to world // space (at least 1); data
    * space must be the world size. Ranks are data-major (rank = d * space
    + s). Every rank must call it, in the same order, as it creates the
    groups: with both axes above 1, one group for every row and then one
    for every column, in order."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data is None:
        data = max(world // space, 1)
    if data < 1 or space < 1 or data * space != world:
        raise ValueError(f"mesh {data}x{space} != {world} ranks")
    d, s = divmod(rank, space)
    data_group = space_group = None
    if data > 1 and space == 1:
        data_group = dist.group.WORLD
    elif space > 1 and data == 1:
        space_group = dist.group.WORLD
    elif data > 1:
        rows = [dist.new_group(list(range(i * space, (i + 1) * space))) for i in range(data)]
        cols = [dist.new_group(list(range(j, world, space))) for j in range(space)]
        space_group, data_group = rows[d], cols[s]
    stats_group = dist.group.WORLD if space > 1 else None
    return Mesh(data, space, d, data_group, space_group, s, stats_group)


def batch_rows(batch_size: int, rank: int, world: int, grad_accum: int = 1) -> list:
    """The rows of a global batch of ``batch_size`` that data rank ``rank``
    of ``world`` takes, in the order its step consumes them.

    The JAX step splits the global batch into ``grad_accum`` microbatches
    of consecutive rows and shards each over 'data'
    (damvsnet_tpu/train/loop.py:46-70): microbatch i is rows
    [i*B/A, (i+1)*B/A), of which rank r holds the r-th of ``world`` equal
    parts. A rank's batch is its parts of microbatches 0..A-1 in order, so
    that cutting it into A consecutive chunks gives each microbatch's part,
    and the union over ranks of chunk i is JAX's microbatch i (its batch
    statistics are taken over that union)."""
    if batch_size % (world * grad_accum):
        raise ValueError(f"the global batch of {batch_size} does not split into "
                         f"{grad_accum} microbatches over {world} data ranks")
    micro = batch_size // grad_accum
    part = micro // world
    return [i * micro + rank * part + j for i in range(grad_accum) for j in range(part)]
