"""Data-parallel training over torch.distributed (port of
parallel/distributed.py).

The JAX package trains data-parallel under GSPMD: parameters replicated,
the batch sharded, and the loss, the BatchNorm batch statistics, the
gradient and its global-norm clip all taken over the global batch. The
port runs one process per rank, each on its local rows, and makes the same
global-batch step with explicit collectives:

- the gradients are all-reduced to their mean before the optimizer and
  its clip (parallel/steps.py::apply_gradients), and the reported loss too;
- train-mode BatchNorm takes its batch statistics over every rank's rows
  (models/blocks.py, SyncBatchNorm's semantics; with one rank it is the
  plain batch_norm);
- the validation metrics are gathered over the ranks once per epoch
  (training/trainer.py).

No DistributedDataParallel wrapper: the steps go through
torch.func.functional_call, and an explicit all-reduce is the direct
counterpart of GSPMD's. The input pipeline is sharded per rank
(data/pipeline.py::AudioLoader shard_index / num_shards).

A rank's process reads torchrun's environment (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE):

    torchrun --nproc_per_node 2 -m birdnet_stm32_tpu_torch train ...
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed() -> bool:
    """Join the process group that torchrun's environment describes; a
    no-op without RANK and WORLD_SIZE. Returns True when a group is (or
    already was) initialized.

    The backend is NCCL where every local rank has a CUDA device of its
    own, else gloo (the CPU, or more ranks than cards: NCCL refuses two
    ranks on one device). Each rank's CUDA device is cuda:LOCAL_RANK modulo
    the device count (local_device()).
    """
    if _grouped():
        return True
    if os.environ.get("RANK") is None or os.environ.get("WORLD_SIZE") is None:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    nccl = torch.cuda.is_available() and torch.cuda.device_count() >= local_world
    backend = "nccl" if nccl else "gloo"
    if nccl:
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend=backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def host_shard() -> tuple[int, int]:
    """(rank, world size) for this process's input pipeline; (0, 1) without
    a process group."""
    if _grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """True on rank 0 (and without a process group): the rank that writes
    the run directory and logs."""
    return host_shard()[0] == 0


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """The rank's device for `device`: a bare 'cuda' becomes
    cuda:LOCAL_RANK modulo the device count under torchrun; anything else
    is returned as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or os.environ.get("LOCAL_RANK") is None:
        return dev
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % max(1, torch.cuda.device_count()))


def rank_seed(seed: int) -> int:
    """The augmentation seed of this rank: `seed` on rank 0 (and in one
    process), a seed drawn from (seed, rank) on the others, so ranks draw
    different masks and mixup pairs."""
    rank, _ = host_shard()
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), rank]).generate_state(1)[0])


def globalize_batch(batch, mesh=None):
    """The identity: each rank keeps its local rows (the global batch is the
    union over ranks, which the step's collectives reduce over)."""
    return batch


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, in one
    collective over a flat float32 buffer; nothing without a process group.
    With a group of one rank the collective runs and changes no bit (a sum
    over one rank, times 1.0)."""
    if not _grouped() or not tensors:
        return
    world = dist.get_world_size()
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.mul_(1.0 / world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset : offset + n].view_as(t))
        offset += n


@torch.no_grad()
def all_reduce_sum_(x: torch.Tensor) -> None:
    """Replace `x` by its sum over the ranks, in place; nothing without a
    process group."""
    if _grouped():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)


def gather_objects(obj) -> list:
    """[rank 0's obj, rank 1's, ...]; [obj] with one rank."""
    if host_shard()[1] == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_state_(tensors: list[torch.Tensor]) -> None:
    """Copy rank 0's values into every rank's tensors, in place."""
    if host_shard()[1] == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)


def destroy() -> None:
    """Leave the process group, if any."""
    if _grouped():
        dist.destroy_process_group()
