"""The training input pipeline (port of data/pipeline.py).

    worker:  decode WAV -> resample -> peak-norm -> smart-crop / split ->
             activity-rank -> top-K waveform chunks (data/worker.py, numpy)
    host:    shuffled reservoir with bounded in-flight dispatch (AudioLoader)
    device:  waveform batch -> dequant -> frontend features (the fused
             frontend kernel on CUDA) -> SpecAugment -> mixup
             (make_train_batcher)

AudioLoader is the JAX package's numpy code: for the same seed it yields
the same batches bit for bit (single-process, and FIFO validation loaders
with any executor). Failed loads give a random-noise chunk with an all-zero
label; workers ignore SIGINT; epochs are infinite unless asked otherwise.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np
import torch

from birdnet_stm32_tpu_torch.data.augment import apply_mixup, apply_spec_augment
from birdnet_stm32_tpu_torch.data.worker import (
    LoaderConfig,
    process_file,
    process_files,
    worker_init,
)

__all__ = ["AudioLoader", "LoaderConfig", "process_file", "make_train_batcher"]


@dataclass(eq=False)  # ndarray field: a synthesized __eq__ would raise
class AudioLoader:
    """Shuffled-reservoir batch iterator over a thread or process pool.

    Yields (waveform [B, T] float32 — or the int16 / mu-law rows of
    cfg.ship_int16 / cfg.ship_ulaw — labels [B, C] float32) numpy batches.
    executor 'thread' (default) decodes in a ThreadPoolExecutor (numpy
    releases the GIL); 'process' in a spawn pool, files_per_task files per
    task. num_workers=0 decodes in the calling thread.

    shard_index / num_shards: each data-parallel rank iterates a disjoint
    slice of the file list, order[shard_index::num_shards] of the same
    epoch-keyed permutation on every rank (parallel/distributed.py::
    host_shard).
    """

    paths: list[str]
    labels: np.ndarray  # [N, C]
    cfg: LoaderConfig
    batch_size: int = 32
    num_workers: int = 4
    shuffle: bool = True
    infinite: bool = True
    reservoir_size: int = 1024
    loader_control: dict = field(default_factory=lambda: {"max_inflight_files": 64})
    shard_index: int = 0
    num_shards: int = 1
    worker_timeout: float = 120.0  # seconds without any result -> RuntimeError
    files_per_task: int = 8
    executor: str = "thread"

    def __post_init__(self):
        assert len(self.paths) == len(self.labels)
        if self.labels.ndim != 2:
            raise ValueError(f"labels must be [N, C], got {self.labels.shape}")
        if self.cfg.num_classes == 0:
            self.cfg.num_classes = int(self.labels.shape[1])
        elif self.labels.shape[1] != self.cfg.num_classes:
            raise ValueError(
                f"labels shape {self.labels.shape} does not match "
                f"LoaderConfig.num_classes={self.cfg.num_classes}: the noise "
                "fallback would emit mismatched label widths")
        self._rng = np.random.default_rng(self.cfg.seed)

    def estimate_samples_per_epoch(self) -> int:
        """Files x average chunks per file: (1 + max_chunks_per_file) / 2."""
        return max(1, int(len(self.paths) * (1 + self.cfg.max_chunks_per_file) / 2.0))

    def _iter_threads(self, tasks, reservoir, low_mark, drain_ready, drain_tail):
        ex = ThreadPoolExecutor(self.num_workers)
        try:
            pending: deque = deque()
            exhausted = False
            while True:
                max_inflight = int(self.loader_control.get("max_inflight_files", 64))
                while not exhausted and len(pending) < max_inflight:
                    try:
                        pending.append(ex.submit(process_file, next(tasks)))
                    except StopIteration:
                        exhausted = True
                if not pending:
                    if exhausted:
                        break
                    time.sleep(0.05)  # paused through loader_control
                    continue
                if self.shuffle:
                    done, _ = wait(set(pending), timeout=self.worker_timeout,
                                   return_when=FIRST_COMPLETED)
                    if not done:
                        raise RuntimeError(
                            f"no loader progress for {self.worker_timeout:.0f}s")
                    pending = deque(f for f in pending if f not in done)
                    for f in done:
                        result = f.result()
                        if result:
                            reservoir.extend(result)
                else:
                    # FIFO (validation): consume in submission order, so the
                    # batches do not depend on thread timing.
                    done, _ = wait({pending[0]}, timeout=self.worker_timeout)
                    if not done:
                        raise RuntimeError(
                            f"no loader progress for {self.worker_timeout:.0f}s")
                    while pending and pending[0].done():
                        result = pending.popleft().result()
                        if result:
                            reservoir.extend(result)
                yield from drain_ready(low_mark)
            yield from drain_tail()
        finally:
            # Abandoned mid-iteration: drop queued decodes.
            ex.shutdown(wait=False, cancel_futures=True)

    def _iter_processes(self, tasks, reservoir, low_mark, drain_ready, drain_tail):
        # Spawn, not fork, and recycle workers rarely: each respawn
        # re-imports numpy and scipy.
        ctx = mp.get_context("spawn")
        group: list = []

        def grouped_tasks():
            nonlocal group
            for task in tasks:
                group.append(task)
                if len(group) >= self.files_per_task:
                    yield group
                    group = []
            if group:
                yield group

        gtasks = grouped_tasks()
        with ctx.Pool(self.num_workers, initializer=worker_init,
                      maxtasksperchild=10_000) as pool:
            try:
                pending = []
                exhausted = False
                last_progress = time.monotonic()
                while True:
                    max_inflight = int(self.loader_control.get("max_inflight_files", 64))
                    while (not exhausted
                           and len(pending) * self.files_per_task < max_inflight):
                        try:
                            pending.append(pool.apply_async(process_files, (next(gtasks),)))
                        except StopIteration:
                            exhausted = True
                    if not pending:
                        if exhausted:
                            break
                        time.sleep(0.05)  # paused: not worker death
                        last_progress = time.monotonic()
                        continue
                    done, still = [], []
                    if self.shuffle:
                        for p in pending:
                            (done if p.ready() else still).append(p)
                    else:
                        while pending and pending[0].ready():
                            done.append(pending.pop(0))
                        still = pending
                    if not done:
                        pending[0].wait(0.05)
                        if time.monotonic() - last_progress > self.worker_timeout:
                            raise RuntimeError(
                                f"no loader progress for {self.worker_timeout:.0f}s — "
                                "worker processes appear dead (spawn requires an "
                                "importable __main__; run from a file/module, not stdin)")
                        continue
                    pending = still
                    for p in done:
                        result = p.get()
                        if result:
                            reservoir.extend(result)
                    yield from drain_ready(low_mark)
                    # After the yield: time parked there (the validation
                    # sweep) is not worker silence.
                    last_progress = time.monotonic()
                yield from drain_tail()
            finally:
                pool.terminate()

    def __iter__(self):
        reservoir: list[tuple[np.ndarray, np.ndarray]] = []
        # Drain down to half the reservoir: the shuffle window.
        low_mark = max(self.batch_size * 2, self.reservoir_size // 2)

        def task_stream():
            epoch = 0
            while True:
                order = np.arange(len(self.paths))
                if self.shuffle:
                    # Epoch-keyed, independent of the reservoir generator:
                    # every rank draws the same permutation.
                    np.random.default_rng((self.cfg.seed, epoch)).shuffle(order)
                if self.num_shards > 1:
                    order = order[self.shard_index :: self.num_shards]
                for i in order:
                    yield (self.paths[i], self.labels[i], self.cfg,
                           epoch * len(self.paths) + int(i))
                epoch += 1
                if not self.infinite:
                    return

        def drain_batch():
            if self.shuffle:
                idx = self._rng.permutation(len(reservoir))[: self.batch_size]
                idx_set = set(idx.tolist())
                batch = [reservoir[i] for i in idx]
                remaining = [s for i, s in enumerate(reservoir) if i not in idx_set]
                reservoir.clear()
                reservoir.extend(remaining)
            else:
                batch = reservoir[: self.batch_size]
                del reservoir[: self.batch_size]
            x = np.stack([b[0] for b in batch])
            y = np.stack([b[1] for b in batch])
            return x, y

        def drain_ready(min_size):
            while len(reservoir) >= max(min_size, self.batch_size):
                yield drain_batch()

        def drain_tail():
            yield from drain_ready(self.batch_size)
            if reservoir and not self.infinite:
                yield drain_batch()  # the final partial batch

        tasks = task_stream()
        if self.num_workers <= 0:
            for task in tasks:
                result = process_file(task)
                if result:
                    reservoir.extend(result)
                yield from drain_ready(low_mark)
            yield from drain_tail()
            return
        run = self._iter_threads if self.executor == "thread" else self._iter_processes
        yield from run(tasks, reservoir, low_mark, drain_ready, drain_tail)


def make_train_batcher(
    cfg,
    spec_augment: bool = True,
    mixup_alpha: float = 0.2,
    mixup_probability: float = 0.25,
    label_smoothing: float = 0.0,
    freq_mask_max: int = 8,
    time_mask_max: int = 25,
    stft_precision: str = "highest",
    feature_dtype: torch.dtype | None = None,
    input_dtype: str | None = None,
):
    """Device transform of one training batch:
    (generator, wave, labels) -> (model inputs, labels).

    wave: [B, T] float32, or with input_dtype 'int16' the [B, T+1] code +
    scale rows of a ship_int16 loader (dequantized by correctly rounded
    float32 division: bit-exact against the float32 feed for PCM16
    sources), with 'ulaw' the [B, T] int8 rows of a ship_ulaw loader. Then
    the frontend (ops/kernels/frontend_kernel.py::frontend_input: the fused
    kernel on CUDA, its plain version on the CPU, the composition for the
    'raw' frontend), SpecAugment (not for 'raw') and mixup, each drawing
    from `generator`. Plain eager PyTorch; the batcher needs no gradient.

    stft_precision goes to frontend_input (the kernels compute the same
    float32 for each; the composition serving 'raw' and the geometries the
    kernels do not take follows it). feature_dtype=torch.bfloat16 (mixed
    precision) casts the batch once, after mixup: the augmentation
    computes in float32 and the step gets bf16 features.
    """
    from birdnet_stm32_tpu_torch.models.serving import _dequantize_int16, _dequantize_ulaw
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input

    if input_dtype not in (None, "float32", "int16", "ulaw"):
        raise ValueError(
            f"input_dtype must be None|'float32'|'int16'|'ulaw', got {input_dtype!r}")
    dequantize = {"int16": _dequantize_int16, "ulaw": _dequantize_ulaw}.get(input_dtype)

    @torch.no_grad()
    def batcher(generator: torch.Generator, wave: torch.Tensor, labels: torch.Tensor):
        if dequantize is not None:
            wave = dequantize(wave)
        x = frontend_input(wave, cfg, stft_precision=stft_precision)
        if spec_augment and cfg.audio_frontend != "raw":
            x = apply_spec_augment(generator, x, freq_mask_max=freq_mask_max,
                                   time_mask_max=time_mask_max)
        x, labels = apply_mixup(generator, x, labels, alpha=mixup_alpha,
                                probability=mixup_probability, label_smoothing=label_smoothing)
        return (x if feature_dtype is None else x.to(feature_dtype)), labels

    return batcher
