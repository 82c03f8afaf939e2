"""Multi-card dry run of the port (counterpart of the JAX package's
`dryrun_multichip`: sharded training over widths 1, 2, 4, ..., n with the
same global batch, then fused sharded serving).

    python -m birdnet_stm32_tpu_torch.scripts.multichip [n] [--device cpu] [--rows_per_card R]

n defaults to every visible card. The widths are 1, 2, 4, ... up to n,
and n itself.

Training (parallel/distributed.py): at each width that divides the global
batch of TRAIN_ROWS, one process per rank, each on a card of its own
(cuda:LOCAL_RANK) in a NCCL process group (gloo on a machine without
CUDA), spawned with torchrun's environment (`spawn_ranks`). Each rank
takes sgd steps (momentum 0.9, dropout off; `run_steps`) of the flagship
(artifacts/flagship/bundle/model_config.json, seeded weights, logits head)
on its rows of the same global batches of kernel features, twice from the
seeded weights: chip_smoke.py's ddp step (lr GATE_LR, per-tensor clip
1.0), held against width 1 by `step_gates`, the gates the ddp phase holds
its two-rank step to (the loss, the gradient norm, each tensor's update
and the whole update in L2, the BN running statistics); then TRAIN_STEPS
steps at TRAIN_LR without a clip, as the JAX dry run takes them, with
every loss finite and the parameters within PARAM_DELTA_BOUND of width
1's after the last (the JAX dry run's bound: summation-order noise grows
over the steps, so the multi-step state gets a gross bound and the step
gates bite on the first). Width 1 is one rank. Reported: each step's loss
and gradient norm and their gaps to width 1, rank 0's step ms (host clock
around the step and the read of its loss), max |delta param| against
width 1.

Serving (parallel/mesh.py::local_mesh, the runners' mesh=): fused serving
of R rows per card at full width (R * n rows) over a mesh of the first w
cards at every width: the INT8 leg (the committed bundle's .tflite)
bit-equal to one card without a mesh, float32 scores (seeded flagship,
softmax head) within SERVE_F32_ATOL, bf16 logits at per-row cosine >=
SERVE_BF16_MIN_COSINE; on CUDA the frontend kernel launched once per card
per batch. Reported: ms per batch (host clock, median of SERVE_REPS calls
that copy the scores back) and chunks/s, per leg and width.

With one card it runs width 1 and says so. Lines of JSON go to stdout, the
last {"multichip": {"ok": ...}}; a failed gate exits 1. --device cpu runs
the same on the CPU (gloo ranks; a mesh of n entries 'cpu'; rates are the
CPU's; the gradient-norm gate is CPU_NORM_RTOL there).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
BUNDLE = ROOT / "artifacts" / "flagship" / "bundle"
TRAIN_ROWS = 16
TRAIN_STEPS = 3
# The ddp gates (chip_smoke.py's ddp phase and the training sweep here):
# width w against one process on the global batch, the same step in another
# summation order. Loss 1e-5 and gradient norm 1e-4 relative, BN running
# statistics within 1e-4 of each tensor's largest value (the single-step
# gates of tests/test_torch_train_step.py). The parameter updates take the
# card-vs-CPU step gates of chip_smoke.py's train phase (5e-2 of each
# tensor's largest entry, 2e-2 in L2 over all): at full width on 16 rows,
# train-mode BN's backward cancels almost all of dy in the last stages (dy
# is nearly constant over a channel before the global pooling), so float32
# rounding alone moves single tensors' gradients by ~2e-3 of their largest
# entry (two exact formulas of the BN gradient in one process on the CPU).
LOSS_RTOL, NORM_RTOL, STATS_RTOL = 1e-5, 1e-4, 1e-4
TENSOR_UPDATE_RTOL, UPDATE_RTOL = 5e-2, 2e-2
# On the CPU the gradient norm is held to the train phase's card-vs-CPU
# gate. The norm is the hybrid mel mixer's (188.8 of 188.8 at init), a sum
# over rows and frames through the per-sample max normalisation that
# cancels most of itself: one process's float32 step (torch's native CPU
# batch_norm) lands 2.0e-4 from a float64 step and width 2's (the explicit
# global-BN formula) 1.5e-5, so width 2 reads 1.8e-4 from width 1
# (tests/test_torch_multichip.py prints both; PERF.md §6).
CPU_NORM_RTOL = 1e-3
# The flagship's gradients at init are ~1e-3 against weights ~1: at lr 1e-2
# a weight's update is ~100 float32 ulps of the weight, and the rounding of
# p + u alone reads as a few % of it. At lr 1.0 the updates are resolved.
GATE_LR = 1.0
# The JAX dry run's trajectory: sgd (momentum 0.9) at 1e-2, and its bound on
# the parameters after the steps.
TRAIN_LR = 1e-2
PARAM_DELTA_BOUND = 2e-2
SERVE_F32_ATOL = 1e-5
SERVE_BF16_MIN_COSINE = 0.999
SERVE_REPS = 5
RANK_TIMEOUT = 600


def widths(n: int) -> list[int]:
    """1, 2, 4, ... below n, and n."""
    out = [1 << i for i in range(n.bit_length()) if 1 << i < n]
    return out + [n]


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    first card's line), or the CPU's name."""
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"


def requests(cfg, rows: int, seed: int) -> np.ndarray:
    """Seeded chirps with noise, [rows, chunk_samples] float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    f0 = rng.uniform(500.0, 6000.0, (rows, 1))
    chirp = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.3 * t))
    return (chirp + rng.normal(0, 0.05, (rows, t.size))).astype(np.float32)


# --- training ---------------------------------------------------------------

def run_steps(data: dict, batches, device) -> dict:
    """make_train_step's steps of the DSCNN `data` describes ({cfg (a
    dict), state_dict, optimizer, lr}, optionally clip_norm: the
    per-tensor clip, 1.0 by default) on each (x, y) of `batches`, dropout
    off and no weight decay, collective under a process group: {loss,
    grad_norm, step_ms (lists; host clock around the step and the read of
    its loss, which waits for the device), variables (a CPU state_dict
    after the steps)}."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
    from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer

    model = build_dscnn(ModelConfig.from_dict(data["cfg"]), class_activation="none",
                        device=device)
    model.load_state_dict(data["state_dict"], strict=True)
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    tx = build_optimizer(data["optimizer"], data["lr"], 0.0, data.get("clip_norm", 1.0))
    step = make_train_step(model, tx, make_loss_fn(multilabel=True, device=device))
    state = TrainState.create(model, tx)
    out = {"loss": [], "grad_norm": [], "step_ms": []}
    for x, y in batches:
        x, y = x.to(device), y.to(device)
        t0 = time.perf_counter()
        state, m = step(state, x, y)
        out["loss"].append(float(m["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norm"].append(float(m["grad_norm"]))
    out["variables"] = {k: v.cpu() for k, v in state.variables().items()}
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def step_gates(got: dict, ref: dict, start: dict, norm_rtol: float = NORM_RTOL) -> dict:
    """One step's run_steps result against the reference's (the same step
    on the global batch in one process) from the weights `start`: the
    relative gaps of the loss and the gradient norm, each tensor's update
    against its largest entry (the worst), the whole update in L2, each BN
    running statistic against its largest value (the worst), and `hold`:
    every reading within its gate (norm_rtol for the gradient norm)."""
    worst_update = worst_stats = diff2 = ref2 = 0.0
    for k, r in ref["variables"].items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got["variables"][k]
        if k.endswith(("running_mean", "running_var")):
            worst_stats = max(worst_stats, float((g - r).abs().max() / r.abs().max()))
            continue
        u, ru = g - start[k], r - start[k]
        diff2 += float(((u - ru) ** 2).sum())
        ref2 += float((ru ** 2).sum())
        if ru.abs().max() > 0:
            worst_update = max(worst_update, float((u - ru).abs().max() / ru.abs().max()))
    g = {"loss_rel": _rel(got["loss"][0], ref["loss"][0]),
         "grad_norm_rel": _rel(got["grad_norm"][0], ref["grad_norm"][0]),
         "worst_tensor_update_rel": worst_update,
         "update_l2_rel": math.sqrt(diff2 / ref2) if ref2 else 0.0,
         "worst_bn_stat_rel": worst_stats}
    g["hold"] = (g["loss_rel"] <= LOSS_RTOL and g["grad_norm_rel"] <= norm_rtol
                 and worst_update <= TENSOR_UPDATE_RTOL and g["update_l2_rel"] <= UPDATE_RTOL
                 and worst_stats <= STATS_RTOL)
    return g


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args: list[str], world: int, **env) -> list[subprocess.Popen]:
    """`python args...` in `world` processes from the repo root with
    torchrun's environment (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE,
    MASTER_ADDR localhost and a free MASTER_PORT) plus `env`, their output
    piped (wait_ranks reads it)."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    base.update(PYTHONPATH=str(ROOT), MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), **env)
    return [subprocess.Popen([sys.executable, *args], cwd=ROOT,
                             env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_ranks(procs: list[subprocess.Popen], what: str, timeout: float = RANK_TIMEOUT) -> None:
    """Wait for every rank (`timeout` seconds each); on a timeout kill them
    all, and raise RuntimeError on it or on a non-zero exit."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"{what}: a rank timed out after {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{what}: rank {r} exited {p.returncode}:\n{out[-3000:]}")


def _rank_main(in_path: str, out_path: str) -> int:
    """One rank of a width: join the group torchrun's environment names,
    take both runs of steps on this rank's rows, rank 0 writes them."""
    from birdnet_stm32_tpu_torch.parallel import distributed

    data = torch.load(in_path, weights_only=False)
    distributed.initialize_distributed()
    rank, world = distributed.host_shard()
    device = distributed.local_device(data["device"])
    try:
        rows = slice(rank * TRAIN_ROWS // world, (rank + 1) * TRAIN_ROWS // world)
        batches = [(x[rows], y[rows]) for x, y in zip(data["x"], data["y"])]
        out = {"gate_step": run_steps({**data, "lr": GATE_LR}, batches[:1], device),
               "steps": run_steps({**data, "lr": TRAIN_LR, "clip_norm": 0.0}, batches, device)}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        distributed.destroy()
    return 0


def _run_width(w: int, in_path: Path, out_path: Path) -> dict:
    """Spawn w ranks and wait for them; rank 0's result."""
    wait_ranks(spawn_ranks(["-m", "birdnet_stm32_tpu_torch.scripts.multichip", "--rank_worker",
                            str(in_path), str(out_path)], w, OMP_NUM_THREADS="1"),
               f"width {w}")
    return torch.load(out_path, weights_only=False)


def _trajectory(got: dict, ref: dict) -> dict:
    """The steps' gaps to width 1's and the parameters' largest gap after
    the last."""
    delta = max(float((got["variables"][k] - r).abs().max())
                for k, r in ref["variables"].items() if not k.endswith("num_batches_tracked"))
    return {"loss_rel": list(map(_rel, got["loss"], ref["loss"])),
            "grad_norm_rel": list(map(_rel, got["grad_norm"], ref["grad_norm"])),
            "max_abs_param_delta": delta, "hold": delta <= PARAM_DELTA_BOUND}


def train_batches(cfg, device: str) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The sweep's TRAIN_STEPS global batches on the host: the frontend's
    features of seeded requests (the kernel on cuda:0, its plain version on
    the CPU) and seeded multi-hot labels."""
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input

    dev0 = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        xs = [frontend_input(torch.from_numpy(requests(cfg, TRAIN_ROWS, 10 + s)).to(dev0),
                             cfg).cpu() for s in range(TRAIN_STEPS)]
    ys = [torch.from_numpy((rng.random((TRAIN_ROWS, cfg.num_classes)) < 0.05)
                           .astype(np.float32)) for _ in range(TRAIN_STEPS)]
    return xs, ys


def train_sweep(cfg, model, n: int, device: str, tmp: Path) -> tuple[list[dict], bool]:
    xs, ys = train_batches(cfg, device)
    start = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"cfg": cfg.to_dict(), "state_dict": start, "x": xs, "y": ys, "device": device,
                "optimizer": "sgd"}, tmp / "train_in.pt")
    norm_rtol = NORM_RTOL if device == "cuda" else CPU_NORM_RTOL
    results, ok, ref = [], True, None
    for w in [w for w in widths(n) if TRAIN_ROWS % w == 0]:
        t0 = time.perf_counter()
        got = _run_width(w, tmp / "train_in.pt", tmp / f"train_w{w}.pt")
        steps = got["steps"]
        line = {"width": w, "loss": steps["loss"], "grad_norm": steps["grad_norm"],
                "rank0_step_ms": steps["step_ms"], "wall_s": time.perf_counter() - t0}
        if ref is None:
            ref = got
        else:
            line["gate_step"] = step_gates(got["gate_step"], ref["gate_step"], start,
                                           norm_rtol)
            line["trajectory"] = _trajectory(steps, ref["steps"])
            ok &= line["gate_step"]["hold"] and line["trajectory"]["hold"]
        ok &= bool(np.isfinite(steps["loss"] + got["gate_step"]["loss"]).all())
        print(json.dumps({"multichip_train": line}), flush=True)
        results.append(line)
    return results, ok


# --- serving ----------------------------------------------------------------

def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def serve_sweep(cfg, n: int, device: str, rows_per_card: int) -> tuple[list[dict], bool]:
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
    from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph

    devices = [f"cuda:{i}" for i in range(n)] if device == "cuda" else ["cpu"] * n
    dev0 = devices[0]
    rows = rows_per_card * n
    wave = requests(cfg, rows, 2)
    graph = TFLiteGraph(BUNDLE / "model_quantized.tflite")
    softmax = init_model(build_dscnn(cfg, device="cpu"), seed=0)
    logits = build_dscnn(cfg, class_activation="none", device="cpu")
    logits.load_state_dict(softmax.state_dict())

    def runner(leg: str, mesh):
        kw = {"device": dev0} if mesh is None else {"mesh": mesh}
        if leg == "int8":
            return TFLiteSimRunner(graph, **kw)
        if leg == "float32":
            return TorchRunner(softmax, cfg, **kw)
        return TorchRunner(logits, cfg, dtype=torch.bfloat16, **kw)

    results, ok = [], True
    for leg in ("int8", "float32", "bf16"):
        ref = make_fused_classifier(runner(leg, None), cfg, device=dev0)(wave)
        for w in widths(n):
            classify = make_fused_classifier(runner(leg, devices[:w]), cfg, device=dev0)
            frontend_kernel.launches.clear()
            got = classify(wave)
            launches = frontend_kernel.launches.total()
            times = []
            for _ in range(SERVE_REPS):
                t0 = time.perf_counter()
                classify(wave)
                times.append(time.perf_counter() - t0)
            ms = 1e3 * sorted(times)[SERVE_REPS // 2]
            line = {"leg": leg, "width": w, "rows": rows, "ms_per_batch": ms,
                    "chunks_per_s": rows / ms * 1e3, "frontend_launches_per_batch": launches,
                    "max_abs_vs_one_card": float(np.abs(got - ref).max())}
            if leg == "int8":
                line["bit_equal"] = held = bool(np.array_equal(got, ref))
            elif leg == "float32":
                held = line["max_abs_vs_one_card"] <= SERVE_F32_ATOL
            else:
                line["min_cosine"] = float(_cosines(got, ref).min())
                held = line["min_cosine"] >= SERVE_BF16_MIN_COSINE
            if device == "cuda":
                held &= launches == w
            line["gates_hold"] = held = bool(held and np.isfinite(got).all())
            ok &= held
            print(json.dumps({"multichip_serve": line}), flush=True)
            results.append(line)
    return results, ok


def run(n: int | None = None, device: str = "cuda", rows_per_card: int = 64) -> bool:
    """The training and serving sweeps; True when every gate held."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model

    resolve_device(device)
    visible = torch.cuda.device_count() if device == "cuda" else n or 1
    n = visible if n is None else n
    if not 1 <= n <= visible:
        raise ValueError(f"{n} cards asked for, {visible} visible")
    if n == 1:
        print(json.dumps({"multichip_note": "one card: width 1 only"}), flush=True)
    cfg = ModelConfig.load(BUNDLE / "model_config.json")
    model = init_model(build_dscnn(cfg, class_activation="none", device="cpu"), seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        train, train_ok = train_sweep(cfg, model, n, device, Path(tmp))
    serve, serve_ok = serve_sweep(cfg, n, device, rows_per_card)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(json.dumps({"multichip": {
        "ok": train_ok and serve_ok, "widths": widths(n), "device": name, "count": n,
        "card": card(device), "train_ok": train_ok, "serve_ok": serve_ok,
        "train_widths": [t["width"] for t in train]}}), flush=True)
    return train_ok and serve_ok


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, help="cards (default: every visible card)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--rows_per_card", type=int, default=64)
    p.add_argument("--rank_worker", nargs=2, metavar=("IN", "OUT"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_worker:
        return _rank_main(*args.rank_worker)
    return 0 if run(args.n, args.device, args.rows_per_card) else 1


if __name__ == "__main__":
    raise SystemExit(main())
