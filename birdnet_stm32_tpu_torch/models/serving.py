"""Fused waveform -> scores classification (port of models/serving.py).

make_fused_classifier runs frontend and model back to back on one device:
on CUDA the spectrogram frontends (hybrid, librosa with any mag_scale,
log_mel, mfcc) are the hand-written fused kernels
(ops/kernels/frontend_kernel.py::frontend_input), on the CPU their plain
version. The composition (ops/frontend.inputs_for_config) serves only what
the kernels' dispatch excludes, as in the JAX package: 2*hop < n_fft, or
the 'raw' frontend. There is no kernel on/off switch.

With a TFLiteSimRunner (the INT8 leg) the model is the bit-exact integer
executor. When the graph starts with QUANTIZE -> TRANSPOSE and the kernels
serve the frontend, the kernel's int8-entry epilogue quantizes straight
into the executor's entry tensor (build_executor(prequantized_input=True));
otherwise the float features feed the graph's own entry QUANTIZE. Both give
the same scores, bit for bit.

Not ported yet (ROADMAP.md): int16 / mu-law ingress, on-device resampling
(input_sample_rate), asynchronous results (as_numpy=False), bf16 runners,
meshes and make_embedder.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    FRONTEND_MODES,
    _kernel_geometry_ok,
    frontend_input,
)
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    entry_quant_params,
    entry_transpose_perm,
)


def make_fused_classifier(runner, cfg, device: str | torch.device = "cuda"):
    """waveform batch [B, T] -> scores [B, C] on `device`.

    Args:
        runner: TorchRunner or TFLiteSimRunner on `device`.
        cfg: ModelConfig (audio + model geometry).
        device: Where frontend and model run; default CUDA (raises if there
            is none).
    """
    dev = resolve_device(device)
    if runner.device != dev:
        raise ValueError(f"runner is on {runner.device}, classifier on {dev}")
    if hasattr(runner, "graph"):
        return _int8_classifier(runner, cfg, dev)

    @torch.no_grad()
    def classify(wave) -> np.ndarray:
        w = torch.as_tensor(np.asarray(wave, np.float32)).to(dev).contiguous()
        # frontend_input and runner.forward each hold TF32 off where it matters.
        return runner.forward(frontend_input(w, cfg)).cpu().numpy()

    return classify


def _int8_classifier(runner, cfg, dev: torch.device):
    """The INT8 leg: frontend kernel -> integer executor, one executor per
    batch size (the runner keeps them)."""
    # Deepest fusion: the kernel quantizes into the executor's entry tensor
    # when the graph starts with QUANTIZE -> TRANSPOSE and a kernel serves
    # this frontend at this geometry (pcen included: the CUDA kernel runs it).
    entry_q = None
    if (cfg.audio_frontend in FRONTEND_MODES
            and _kernel_geometry_ok(cfg, cfg.chunk_samples)
            and entry_transpose_perm(runner.graph) is not None):
        entry_q = entry_quant_params(runner.graph)

    @torch.no_grad()
    def classify(wave) -> np.ndarray:
        w = torch.as_tensor(np.asarray(wave, np.float32)).to(dev).contiguous()
        fwd = runner.executor(w.shape[0], prequantized_input=entry_q is not None)
        return fwd(frontend_input(w, cfg, quant=entry_q)).cpu().numpy()

    classify.entry_quant = entry_q
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
