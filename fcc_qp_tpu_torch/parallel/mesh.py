"""Devices and batch placement for batch-parallel solving (port of
`fcc_qp_tpu/parallel/mesh.py`).

QP instances are independent, so the batch is split over devices. The
JAX package names a 1-D device mesh and lets XLA partition one program;
here a mesh is a list of torch devices, each shard a batch slice placed
on one of them and solved there, and a multi-process job (one process
per card, or per host) is joined with `torch.distributed`.

A `Sharding` says how a tree of tensors (a `types.QPBatch`, a
`WarmStart`, a `core.ds_engine.QPBatchDS`, a dict, a tuple) is placed:
split along its batch axis over the mesh (``axis`` 0 for batch-leading
data, -1 for the ds engine's batch-last data), or copied whole to every
device (``axis=None``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from fcc_qp_tpu_torch.core.ds_engine import resolve_device
from fcc_qp_tpu_torch.utils.tree import leaves, map_tree, pad_batch  # noqa: F401

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = BATCH_AXIS) -> list:
    """The devices a batch is split over: the given ones (a device may
    repeat: two shards on one card), or every visible card (raises when
    there is none). ``axis_name`` is accepted for the JAX signature; a
    mesh here has the one batch axis."""
    del axis_name
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement of trees over ``devices``: split along ``axis`` (equal
    shards, the batch a multiple of the mesh size), or whole on every
    device when ``axis`` is None."""

    devices: tuple
    axis: Optional[int] = 0

    def place(self, tree) -> list:
        """One tree per device: its shard (or the whole tree) there."""
        n = len(self.devices)
        if self.axis is None:
            return [map_tree(lambda a, d=d: a.to(d), tree)
                    for d in self.devices]
        b = leaves(tree)[0].shape[self.axis]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of the mesh "
                             f"size {n}; pad it first (pad_batch)")
        s = b // n
        return [map_tree(lambda a, i=i, d=d: a.narrow(self.axis, i * s, s)
                         .contiguous().to(d), tree)
                for i, d in enumerate(self.devices)]


def batch_sharding(mesh: Sequence, axis_name: str = BATCH_AXIS) -> Sharding:
    """Split the leading (batch) axis over the mesh."""
    del axis_name
    return Sharding(tuple(mesh), 0)


def replicated(mesh: Sequence) -> Sharding:
    """The whole tree on every device of the mesh."""
    return Sharding(tuple(mesh), None)


def shard_batch_tree(tree, mesh: Sequence, axis_name: str = BATCH_AXIS):
    """Every leaf's leading axis split over the mesh: a list of one tree
    per device (the batch must divide evenly; see `pad_batch`)."""
    return batch_sharding(mesh, axis_name).place(tree)


def init_distributed(**kwargs) -> bool:
    """Join a multi-process job with `torch.distributed.init_process_group`
    when the environment names one (``WORLD_SIZE`` > 1, with
    ``MASTER_ADDR`` / ``MASTER_PORT`` or an ``init_method`` in
    ``kwargs``) or ``kwargs`` give a ``world_size`` above 1; a no-op for a
    single process and when already joined. The backend defaults to NCCL
    with a card and gloo without. Returns whether a multi-process job is
    joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(kwargs.get("world_size", os.environ.get("WORLD_SIZE", 1)))
    if world <= 1 or not dist.is_available():
        return False
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    if "init_method" not in kwargs and "store" not in kwargs:
        kwargs.setdefault("world_size", world)
        kwargs.setdefault("rank", int(os.environ.get("RANK", 0)))
    dist.init_process_group(**kwargs)
    return True
