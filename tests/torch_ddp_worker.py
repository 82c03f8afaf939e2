"""One rank of a data-parallel train step of the port (no JAX), and the same
step in one process, for tests/test_torch_distributed.py and chip_smoke.py.

    python -m tests.torch_ddp_worker IN.pt OUT.pt RANK WORLD PORT BACKEND DEVICE
    python -m tests.torch_ddp_worker train OUT_PREFIX TRAIN_ARGS...

IN.pt holds {cfg, state_dict, x, y, optimizer, lr, steps}: a DSCNN config
(dict), its weights, a global batch of features and labels. The rank joins
a process group of WORLD ranks at tcp://localhost:PORT over BACKEND, steps
on its rows x[rank * B / WORLD : (rank + 1) * B / WORLD] through
scripts/multichip.py::run_steps (parallel/steps.py::make_train_step), and
rank 0 writes {loss, grad_norm, variables} after the steps to OUT.pt.
BACKEND `none` steps on every row without a process group: the reference.
Dropout is off and torch's deterministic algorithms are on (with cuBLAS's
deterministic workspace), so the step is a function of the batch alone and
two runs of it are bit-equal on the card too (cuDNN's deterministic flag
alone is not enough: two runs of the flagship step differ by an ulp in 13
tensors on an H100).

The `train` form runs the port's `train` verb in this process as one rank
of torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK, LOCAL_WORLD_SIZE set by the caller), counting its train steps,
its validation batches and the frontend kernels' launches, and writes them
with each step's loss and host milliseconds (the step and the read of its
loss, which waits for the card) to OUT_PREFIX<rank>.json.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist

from birdnet_stm32_tpu_torch.scripts.multichip import run_steps


def train_rank(out_prefix: str, train_args: list[str]) -> int:
    import json

    from birdnet_stm32_tpu_torch.__main__ import main as port_main
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.training import trainer

    seen = {"steps": 0, "val": 0, "losses": [], "step_ms": []}
    real_train, real_step = trainer.train_model, trainer.make_train_step

    def spy_train(model, cfg, train_batches, val_batches, run_dir, **kw):
        def val():
            for b in val_batches():
                seen["val"] += 1
                yield b

        return real_train(model, cfg, train_batches, val, run_dir, **kw)

    def spy_step(*a, **k):
        step = real_step(*a, **k)

        def counted(state, x, y):
            t0 = time.perf_counter()
            state, m = step(state, x, y)
            seen["losses"].append(float(m["loss"]))  # waits for the step
            seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
            seen["steps"] += 1
            return state, m

        return counted

    trainer.train_model, trainer.make_train_step = spy_train, spy_step
    frontend_kernel.launches.clear()
    t0 = time.perf_counter()
    rc = port_main(["train", *train_args])
    seen.update(rc=rc, seconds=time.perf_counter() - t0, launches=dict(frontend_kernel.launches))
    with open(f"{out_prefix}{os.environ['RANK']}.json", "w") as f:
        json.dump(seen, f)
    return rc


def main(argv: list[str]) -> int:
    if argv[0] == "train":
        return train_rank(argv[1], argv[2:])
    in_path, out_path, rank, world, port, backend, device = argv
    rank, world = int(rank), int(world)
    # Before cuBLAS starts: its deterministic workspace.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    grouped = backend != "none"
    if grouped:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
    try:
        data = torch.load(in_path, weights_only=False)
        b = data["x"].shape[0]
        rows = slice(rank * b // world, (rank + 1) * b // world)
        result = run_steps(data, [(data["x"][rows], data["y"][rows])] * data["steps"],
                           torch.device(device))
        if rank == 0:
            torch.save(result, out_path)
    finally:
        if grouped:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
