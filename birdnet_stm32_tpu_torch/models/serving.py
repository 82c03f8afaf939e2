"""Fused waveform -> scores classification (port of models/serving.py).

make_fused_classifier runs frontend and model back to back on one device:
on CUDA the spectrogram frontends (hybrid, librosa with any mag_scale,
log_mel, mfcc) are the hand-written fused kernels
(ops/kernels/frontend_kernel.py::frontend_input), on the CPU their plain
version. The composition (ops/frontend.inputs_for_config) serves only what
the kernels' dispatch excludes, as in the JAX package: 2*hop < n_fft, or
the 'raw' frontend. There is no kernel on/off switch.

Not ported yet (ROADMAP.md): the INT8 runner leg, int16 / mu-law ingress,
on-device resampling (input_sample_rate), asynchronous results
(as_numpy=False), bf16 runners, meshes and make_embedder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input


def make_fused_classifier(runner, cfg, device: str | torch.device = "cuda"):
    """waveform batch [B, T] -> scores [B, C] on `device`.

    Args:
        runner: TorchRunner whose model lives on `device`.
        cfg: ModelConfig (audio + model geometry).
        device: Where frontend and model run; default CUDA (raises if there
            is none).
    """
    dev = resolve_device(device)
    if runner.device != dev:
        raise ValueError(f"runner is on {runner.device}, classifier on {dev}")

    @torch.no_grad()
    def classify(wave) -> np.ndarray:
        w = torch.as_tensor(np.asarray(wave, np.float32)).to(dev).contiguous()
        # frontend_input and runner.forward each hold TF32 off where it matters.
        return runner.forward(frontend_input(w, cfg)).cpu().numpy()

    return classify


def classify_in_batches(classify, chunks: np.ndarray, batch_size: int):
    """Run [N, T] chunks through a fixed-batch classifier, padding the tail.

    Returns:
        ([N, C] scores, seconds spent in classify calls).
    """
    scores, dt = [], 0.0
    for i in range(0, len(chunks), batch_size):
        wave = chunks[i : i + batch_size]
        n = wave.shape[0]
        if n < batch_size:
            wave = np.pad(wave, ((0, batch_size - n), (0, 0)))
        t0 = time.perf_counter()
        scores.append(np.asarray(classify(wave))[:n])
        dt += time.perf_counter() - t0
    return np.concatenate(scores), dt


def top_predictions(pooled: np.ndarray, top_k: int, score_threshold) -> list[int]:
    """Top-k class indices; ranks past the first must clear score_threshold
    (a scalar, or a per-class [C] vector). The top-1 is always kept."""
    thr = np.broadcast_to(np.asarray(score_threshold, np.float32), pooled.shape)
    top = np.argsort(pooled)[::-1][:top_k]
    return [int(i) for rank, i in enumerate(top)
            if rank == 0 or pooled[i] >= thr[i]]
