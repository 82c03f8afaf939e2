"""Data-parallel layout (port of parallel/mesh.py).

The JAX package lays a 1-D `data` mesh over its devices: parameters
replicated, the batch sharded along the mesh, the result gathered in row
order. The port has two such meshes:

- serving over the local devices of one process (`local_mesh`): a list of
  devices in mesh order, the runners' `mesh=` (models/runners.py). A batch
  is split into equal row blocks, one per entry (`shard_batch`), each block
  runs on its device against that device's replica (`replicated`), and
  `gather` concatenates the results in row order on the first device. A
  list may name one device more than once: two entries on cuda:0 split and
  gather on one card;
- training over ranks (parallel/distributed.py): each rank is a process on
  one device, so the mesh is the ranks' devices in rank order
  (`make_mesh`), and sharding a batch is each rank loading its own rows
  (data/pipeline.py::AudioLoader shard_index / num_shards).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.parallel import distributed

DATA_AXIS = "data"


def make_mesh(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices of the ranks in rank order: this process's
    (distributed.local_device) gathered over the process group; one entry
    without a group."""
    return [torch.device(d) for d in
            distributed.gather_objects(str(distributed.local_device(device)))]


def local_mesh(devices=None) -> list[torch.device]:
    """The devices one process serves on, in mesh order, each through
    resolve_device: by default every visible CUDA device (as JAX's
    make_mesh() takes jax.devices()), raising without CUDA; else the given
    list, which may repeat a device."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_batch(batch, mesh: list[torch.device]) -> list[torch.Tensor]:
    """A [B, ...] array or tensor as len(mesh) row blocks of B / len(mesh)
    rows, block k on mesh[k]. B must be a multiple of the width, as under
    JAX's sharded jit (pad_to_multiple pads it). A mesh of one device keeps
    the batch as one block."""
    n, rows = len(mesh), batch.shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not divide over a mesh of "
                         f"{n} devices (pad it with pad_to_multiple)")
    blocks = torch.chunk(batch, n) if isinstance(batch, torch.Tensor) else np.split(batch, n)
    return [torch.as_tensor(b).to(d) for b, d in zip(blocks, mesh)]


def gather(blocks: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The row blocks of a mesh concatenated in mesh order on `device`; a
    single block is returned as it is."""
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([b.to(device) for b in blocks])


def replicated(tree, mesh: list[torch.device]) -> dict:
    """{device: the tree there} for each distinct device of the mesh: a
    module is kept on the device its parameters lie on and deep-copied to
    each other one; tensors (alone or in a dict, list or tuple) are moved.
    Entries that repeat a device share its replica."""
    def on(x, dev):
        if isinstance(x, torch.nn.Module):
            here = next(x.parameters(), None)
            return x if here is not None and here.device == dev else copy.deepcopy(x).to(dev)
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: on(v, dev) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(on(v, dev) for v in x)
        return x

    return {dev: on(tree, dev) for dev in dict.fromkeys(mesh)}


def pad_to_multiple(batch, multiple: int):
    """Right-pad the batch dimension of every array of a (nested) list,
    tuple or dict to a multiple of `multiple` with zero rows.

    Returns (padded batch, real row count); callers mask losses and
    metrics with the count.
    """
    def pad(x):
        b = x.shape[0]
        rem = (-b) % multiple
        if rem == 0:
            return x
        return np.pad(np.asarray(x), [(0, rem)] + [(0, 0)] * (x.ndim - 1))

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [v for t in tree for v in leaves(t)]
        return [tree] if tree is not None else []

    def mapped(tree):
        if isinstance(tree, dict):
            return {k: mapped(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mapped(t) for t in tree)
        return pad(tree) if tree is not None else None

    found = leaves(batch)
    return mapped(batch), (found[0].shape[0] if found else 0)
