"""The world as a (data, model) mesh of ranks (port of
``turboprune_tpu/parallel/mesh.py``).

The JAX package jits one SPMD step over a ``Mesh`` of every device: the
state replicated, the batch sharded on ``data``, and XLA inserts the
gradient all-reduce and computes BatchNorm's statistics over the global
batch; ring attention shards the sequence over ``model``
(``parallel/ring.py``). The port follows PyTorch's idiom of one process
per device: ``create_mesh`` lays the launched world out as a (data, model)
grid of ranks, each rank keeps its data row's part of the global batch
(``shard_batch``), ``average_gradients`` runs once after ``backward()``
over the data group (the counterpart of the psum), ``all_reduce_sums``
adds up an epoch's metric sums, and the BatchNorm layers take their
training statistics over the data group (``models/resnet.py::FlaxBatchNorm2d``,
given the group by ``set_batchnorm_group``). The ranks of one model row
(a ring) hold the same rows and run everything outside attention
replicated, as XLA runs it outside ``shard_map``: their activations,
gradients and sums are identical, so the data group alone reduces them.

Why not DDP's Reducer: the step takes its gradient through
``functional_call`` on ``w * m`` (``train/steps.py``), outside the module's
own ``forward``, and the compiled step's backward is one AOTAutograd graph.
One bucketed all-reduce after the backward needs neither hooks nor a
wrapper module, serves the eager step and a plan's re-instantiated model
alike, and in a data axis of one is not called at all.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .multihost import process_count, process_index

# Gradient bytes per all-reduce (DDP's default bucket).
BUCKET_BYTES = 25 * 2**20


@dataclass(frozen=True)
class Mesh:
    """The world as a (data, model) grid of ranks, ``grid[i, j]`` the rank
    at data row i and model column j. ``data_group`` is the process group
    of this rank's column (the ranks that hold the other rows of its
    batch), None in a data axis of one; ``model_group`` is its row (the
    ring its sequence is sharded over), None in a model axis of one."""

    grid: np.ndarray
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def data_size(self) -> int:
        return self.grid.shape[0]

    @property
    def model_size(self) -> int:
        return self.grid.shape[1]

    @property
    def data_rank(self) -> int:
        """This rank's row of the grid: which rows of a batch it keeps."""
        return int(np.argwhere(self.grid == process_index())[0][0])

    @property
    def model_rank(self) -> int:
        """This rank's column of the grid: its place on the ring, which
        shard of the sequence it holds."""
        return int(np.argwhere(self.grid == process_index())[0][1])


def create_mesh(num_devices: int = 0, model_parallelism: int = 1) -> Mesh:
    """The launched world as a (data, model) mesh. ``num_devices=0`` means
    the whole world; any other value must equal its size: a run configured
    for 4 devices does not quietly train on fewer."""
    n = process_count()
    if num_devices and num_devices != n:
        raise ValueError(
            f"create_mesh(num_devices={num_devices}): the launched world has {n} "
            "process(es), one per device — refusing to silently under-provision "
            "the mesh (launch with torchrun --nproc_per_node="
            f"{num_devices}, or set experiment_params.num_devices=0)"
        )
    if model_parallelism < 1 or n % model_parallelism:
        raise ValueError(f"{n} devices not divisible by model_parallelism={model_parallelism}")
    grid = np.arange(n).reshape(n // model_parallelism, model_parallelism)
    data_size, model_size = grid.shape
    if model_size == 1:
        return Mesh(grid, dist.group.WORLD if n > 1 else None)
    # torch makes a group collectively: every rank creates every group, in
    # the same order, and keeps its own column and row.
    row, col = np.argwhere(grid == process_index())[0]
    columns = [dist.new_group(grid[:, j].tolist()) if data_size > 1 else None
               for j in range(model_size)]
    rows = [dist.new_group(grid[i].tolist()) for i in range(data_size)]
    return Mesh(grid, columns[col], rows[row])


def shard_batch(batch: tuple, mesh: Mesh, scope: str = "global") -> tuple:
    """This rank's part of a loader batch. A ``"global"``-scope loader
    (device CIFAR, synthetic) hands every rank the whole global batch of
    B rows, and rank r keeps rows [r·B/W, (r+1)·B/W); a ``"host"``-scope
    loader (.tpk, ImageFolder) already hands each rank its own rows."""
    if mesh.data_size == 1 or scope == "host":
        return batch
    if scope != "global":
        raise ValueError(f"unknown batch scope {scope!r}")
    w, r = mesh.data_size, mesh.data_rank
    out = []
    for t in batch:
        if t.shape[0] % w:
            raise ValueError(f"batch of {t.shape[0]} rows does not divide over {w} data ranks")
        b = t.shape[0] // w
        out.append(t[r * b:(r + 1) * b])
    return tuple(out)


def average_gradients(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Replace every gradient by its mean over the data group: one
    all-reduce per bucket of flattened gradients of one dtype, as a SUM
    divided by the group's size (gloo has no AVG). Every rank holds the
    same parameters, so the buckets line up."""
    if mesh.data_size == 1:
        return
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for g in (p.grad for p in params if p.grad is not None):
        nbytes = g.numel() * g.element_size()
        if not buckets or g.dtype != buckets[-1][0].dtype or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=mesh.data_group)
        flat /= mesh.data_size
        for t, avg in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(avg.view_as(t))


def all_reduce_sums(sums: dict, mesh: Mesh) -> dict:
    """An epoch's or an evaluation's metric sums (``loss_sum``,
    ``correct``, ``count``) added up over the data group, in one
    all-reduce, so every rank reads the global numbers."""
    if mesh.data_size == 1:
        return sums
    keys = sorted(sums)
    flat = torch.stack([sums[k].float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    return dict(zip(keys, flat.unbind(0)))


@torch.no_grad()
def broadcast_module(model: nn.Module, mesh: Mesh, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank of the world, in
    place: the start-of-run broadcast DDP makes (the JAX package's
    ``replicate``). Over the world, not the data group: ``src`` is a
    global rank, and the ranks of a ring hold the same weights too."""
    if mesh.grid.size == 1:
        return
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=src)


def set_batchnorm_group(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """Give every BatchNorm layer of ``model`` the data group it takes its
    training statistics over (None, or a data axis of one: the rank's own
    batch, the forward of a world of one)."""
    group = mesh if mesh is not None and mesh.data_size > 1 else None
    for module in model.modules():
        if hasattr(module, "sync_mesh"):
            module.sync_mesh = group


@contextlib.contextmanager
def local_batchnorm(model: nn.Module):
    """BatchNorm over the rank's own batch inside the block, on every rank
    alike. The data-driven criteria score the whole global batch on every
    rank; their statistics are those of a world of one without a
    collective."""
    saved = [(m, m.sync_mesh) for m in model.modules() if hasattr(m, "sync_mesh")]
    for m, _ in saved:
        m.sync_mesh = None
    try:
        yield
    finally:
        for m, mesh in saved:
            m.sync_mesh = mesh
