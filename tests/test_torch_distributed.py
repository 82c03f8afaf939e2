"""PyTorch port, data-parallel training (parallel/distributed.py,
parallel/mesh.py, the rank-aware BN, step, loader and trainer) on the CPU
over gloo.

- Two processes, each stepping on half of a global batch of features
  (tests/torch_ddp_worker.py), equal one process's step on the whole batch
  within the single-step gates of tests/test_torch_train_step.py (PR 8):
  loss within 1e-5 relative, gradient norm within 1e-4 relative, each sgd
  parameter update within 1e-3 of that tensor's largest update, and the BN
  running statistics within 1e-4 of each tensor's largest value. That is
  the JAX step's global-batch semantics under GSPMD (the loss, the BN
  batch statistics, the gradient and its clip over the global batch); the
  two sides differ only in float32 summation order. Without the BN
  all-reduce the statistics of each half differ from the whole batch's by
  far more than the gates (checked below).
- AudioLoader's rank shards equal the JAX loader's order[shard::num_shards]
  bit for bit, and pad_to_multiple equals JAX's.
- `train` under two gloo ranks: only rank 0 writes the run directory.
Spawned processes carry their own timeouts.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.data.pipeline import AudioLoader as JAudioLoader
from birdnet_stm32_tpu.data.worker import LoaderConfig as JLoaderConfig
from birdnet_stm32_tpu.parallel import mesh as JM
from birdnet_stm32_tpu_torch.data import dataset as D
from birdnet_stm32_tpu_torch.data.pipeline import AudioLoader, LoaderConfig
from birdnet_stm32_tpu_torch.parallel import distributed, mesh
from birdnet_stm32_tpu_torch.scripts.multichip import run_steps
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import one_torch_thread, pair  # noqa: F401
from tests.torch_train_fixtures import write_wav_folder

warm_up()

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _communicate(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank timed out")
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    return outs


def _env(**extra):
    """This process's environment without torchrun's variables, plus extra."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    return {**env, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **extra}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """One sgd step on a global batch of 8: in two gloo processes (rank 0's
    result) and in this process."""
    _, _, model, _, cfg = pair(seed=4)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((8, *cfg.input_shape())).astype(np.float32))
    y = torch.from_numpy((rng.random((8, cfg.num_classes)) < 0.4).astype(np.float32))
    data = {"cfg": cfg.to_dict(), "state_dict": model.state_dict(), "x": x, "y": y,
            "optimizer": "sgd", "lr": 1e-2, "steps": 1}
    root = tmp_path_factory.mktemp("ddp")
    torch.save(data, root / "in.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_ddp_worker", str(root / "in.pt"),
         str(root / "out.pt"), str(rank), "2", str(port), "gloo", "cpu"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    _communicate(procs)
    two = torch.load(root / "out.pt", weights_only=False)
    one = run_steps(data, [(x, y)], torch.device("cpu"))
    halves = [run_steps(data, [(x[s], y[s])], torch.device("cpu"))
              for s in (slice(0, 4), slice(4, 8))]
    return data, one, two, halves


def test_two_rank_step_equals_global_batch_step(step_case):
    data, one, two, _ = step_case
    assert _rel(two["loss"][0], one["loss"][0]) <= 1e-5
    assert _rel(two["grad_norm"][0], one["grad_norm"][0]) <= 1e-4
    before = data["state_dict"]
    assert two["variables"].keys() == one["variables"].keys()
    n_bn = 0
    for k, ref in one["variables"].items():
        got = two["variables"][k]
        if k.endswith("num_batches_tracked"):
            assert int(got) == int(ref) == 1
        elif k.endswith(("running_mean", "running_var")):
            n_bn += 1
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max(), k
        else:
            u, ju = got - before[k], ref - before[k]
            assert (u - ju).abs().max() <= 1e-3 * ju.abs().max(), k
    assert n_bn > 10


def test_the_bn_all_reduce_is_what_makes_it_global(step_case):
    """A half batch's own BN statistics are far from the global batch's:
    the gates above could not pass without the cross-rank sums."""
    _, one, _, halves = step_case
    worst = 0.0
    for k, ref in one["variables"].items():
        if k.endswith("running_var"):
            got = halves[0]["variables"][k]
            worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    assert worst > 1e-2


def test_world_of_one_changes_no_bit(tmp_path):
    """A process group of one rank (gloo here; NCCL on the card): the
    gradient all-reduce runs and the step equals the step without a group
    bit for bit."""
    _, _, model, _, cfg = pair(seed=5)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((4, *cfg.input_shape())).astype(np.float32))
    y = torch.from_numpy((rng.random((4, cfg.num_classes)) < 0.4).astype(np.float32))
    data = {"cfg": cfg.to_dict(), "state_dict": model.state_dict(), "x": x, "y": y,
            "optimizer": "adam", "lr": 1e-3, "steps": 2}
    torch.save(data, tmp_path / "in.pt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.torch_ddp_worker", str(tmp_path / "in.pt"),
         str(tmp_path / "out.pt"), "0", "1", str(_free_port()), "gloo", "cpu"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _communicate([proc])
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    ref = run_steps(data, [(x, y)] * data["steps"], torch.device("cpu"))
    assert got["loss"] == ref["loss"] and got["grad_norm"] == ref["grad_norm"]
    for k, v in ref["variables"].items():
        assert torch.equal(got["variables"][k], v), k


def test_loader_shards_equal_jax(tmp_path):
    root = write_wav_folder(tmp_path / "data", 4000, files_per_class=3, seed=2)
    paths, labels, classes = D.load_file_paths_from_directory(root)
    onehot = D.one_hot_labels(labels, classes)

    def batches(cls, cfg_cls, shard, shuffle):
        cfg = cfg_cls(sample_rate=4000, chunk_duration=1.0, seed=7, max_chunks_per_file=2)
        loader = cls(paths, onehot, cfg, batch_size=3, num_workers=0, shuffle=shuffle,
                     infinite=shuffle, reservoir_size=8, shard_index=shard, num_shards=2)
        out = []
        for x, y in loader:
            out.append((x, y))
            if len(out) == 5:
                break
        return out

    for shuffle in (True, False):
        shards = []
        for shard in (0, 1):
            got = batches(AudioLoader, LoaderConfig, shard, shuffle)
            ref = batches(JAudioLoader, JLoaderConfig, shard, shuffle)
            assert len(got) == len(ref) >= 3
            for (x, y), (jx, jy) in zip(got, ref):
                np.testing.assert_array_equal(x, jx)
                np.testing.assert_array_equal(y, jy)
            shards.append(np.concatenate([x for x, _ in got]))
        assert not np.array_equal(shards[0][:3], shards[1][:3])  # disjoint slices


def test_pad_to_multiple_equals_jax():
    rng = np.random.default_rng(0)
    for b in (5, 8):
        batch = {"x": rng.random((b, 3, 2)).astype(np.float32),
                 "y": (rng.random((b, 4)) > 0.5).astype(np.float32)}
        got, n = mesh.pad_to_multiple(batch, 4)
        ref, jn = JM.pad_to_multiple(batch, 4)
        assert n == jn == b
        for k in batch:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
        assert got["x"].shape[0] == -(-b // 4) * 4
    pair_batch = (rng.random((3, 2)), rng.random((3,)))
    got, n = mesh.pad_to_multiple(pair_batch, 2)
    ref, jn = JM.pad_to_multiple(pair_batch, 2)
    assert n == jn == 3 and all(np.array_equal(a, np.asarray(r)) for a, r in zip(got, ref))


def test_helpers_without_a_group(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize_distributed() is False
    assert distributed.host_shard() == (0, 1) and distributed.is_main_process()
    assert distributed.rank_seed(42) == 42
    assert mesh.make_mesh("cpu") == [torch.device("cpu")]
    batch = (np.ones(3),)
    assert distributed.globalize_batch(batch) is batch
    t = torch.ones(3)
    distributed.all_reduce_mean_([t])
    assert torch.equal(t, torch.ones(3))
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_device("cpu") == torch.device("cpu")
    assert distributed.local_device("cuda:0") == torch.device("cuda:0")


def test_only_rank_zero_writes_the_run_directory(tmp_path):
    """`train` in two gloo ranks (through tests/torch_ddp_worker.py's
    `train` form, as chip_smoke.py runs it) with a relative --run_dir and a
    working directory of its own each: rank 0's holds the run, rank 1's
    nothing; both take every step and report the same global losses."""
    data = write_wav_folder(tmp_path / "data", 4000, files_per_class=3, seed=1)
    port = _free_port()
    args = ["--device", "cpu", "--data_path_train", str(data), "--run_dir", "run",
            "--sample_rate", "4000", "--chunk_duration", "1.0", "--fft_length", "128",
            "--num_mels", "16", "--spec_width", "32", "--alpha", "0.25",
            "--embeddings_size", "32", "--no_se", "--no_inverted_residual",
            "--epochs", "2", "--steps_per_epoch", "2", "--batch_size", "4",
            "--num_workers", "0"]
    procs = []
    for rank in (0, 1):
        cwd = tmp_path / f"cwd{rank}"
        cwd.mkdir()
        env = _env(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", "tests.torch_ddp_worker", "train",
                                       str(tmp_path / "rank"), *args], cwd=cwd, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = _communicate(procs)
    run = tmp_path / "cwd0" / "run"
    for f in ("model_config.json", "labels.txt", "history.csv", "train_state.json",
              "best/state_dict.pt", "last/train_state.pt"):
        assert (run / f).exists(), f
    assert len((run / "history.csv").read_text().strip().splitlines()) == 3  # header + 2
    assert list((tmp_path / "cwd1").iterdir()) == []
    assert "[train]" in outs[0] and "[train]" not in outs[1]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]
    assert [r["rc"] for r in ranks] == [0, 0] and [r["steps"] for r in ranks] == [4, 4]
    assert ranks[0]["losses"] == ranks[1]["losses"] and len(ranks[0]["step_ms"]) == 4
