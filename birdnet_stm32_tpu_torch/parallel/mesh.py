"""Data-parallel layout (port of parallel/mesh.py).

The JAX package lays a 1-D `data` mesh over its devices: parameters
replicated, the batch sharded along the mesh. In the port each rank is a
process on one device (parallel/distributed.py), so the mesh is the ranks'
devices in rank order, and sharding a batch is each rank loading its own
rows (data/pipeline.py::AudioLoader shard_index / num_shards).
"""

from __future__ import annotations

import numpy as np
import torch

from birdnet_stm32_tpu_torch.parallel import distributed

DATA_AXIS = "data"


def make_mesh(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices of the ranks in rank order: this process's
    (distributed.local_device) gathered over the process group; one entry
    without a group."""
    return [torch.device(d) for d in
            distributed.gather_objects(str(distributed.local_device(device)))]


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
