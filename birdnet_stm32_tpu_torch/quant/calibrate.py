"""Representative calibration data for post-training quantization (port of
quant/calibrate.py).

A seeded random sample of files, the center chunk of each, model-input
features, near-silent chunks dropped (RMS for raw waveforms, mean |x| for
spectrograms). The features come from ops/frontend.py::inputs_for_config,
the composition, on the caller's device (default CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from birdnet_stm32_tpu_torch.audio.io import load_audio_file
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config


def random_representative_inputs(
    cfg: ModelConfig,
    num_samples: int = 100,
    seed: int = 0,
) -> np.ndarray:
    """[N, ...] random model inputs for calibration and validation when no
    audio is given: uniform [0, 1) for spectrogram frontends, standard
    normal for raw waveforms."""
    rng = np.random.default_rng(seed)
    shape = (num_samples, *cfg.input_shape())
    if cfg.audio_frontend == "raw":
        return rng.standard_normal(shape).astype(np.float32)
    return rng.random(shape, dtype=np.float32)


def representative_inputs(
    file_paths: list[str],
    cfg: ModelConfig,
    num_samples: int = 100,
    snr_threshold: float = 0.01,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """[N, ...] float32 model-input calibration tensors (N <= num_samples),
    computed on `device`."""
    if not file_paths:
        raise ValueError("No audio files found for representative dataset generation.")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sampled = list(rng.choice(file_paths, size=min(num_samples, len(file_paths)), replace=False))
    rep_max_duration = max(30.0, cfg.chunk_duration * 5.0)

    waves = []
    for path in sampled:
        chunks = load_audio_file(path, sample_rate=cfg.sample_rate,
                                 max_duration=rep_max_duration,
                                 chunk_duration=cfg.chunk_duration)
        if chunks.shape[0] == 0:
            continue
        center = chunks[chunks.shape[0] // 2]
        if snr_threshold > 0 and cfg.audio_frontend == "raw":
            if float(np.sqrt(np.mean(center**2))) < snr_threshold:
                continue
        waves.append(center)
    if not waves:
        raise ValueError("All calibration chunks were filtered as silent.")

    with torch.no_grad(), full_fp32():
        x = inputs_for_config(torch.from_numpy(np.stack(waves)).to(dev), cfg).cpu().numpy()
    if snr_threshold > 0 and cfg.audio_frontend != "raw":
        keep = np.abs(x).mean(axis=tuple(range(1, x.ndim))) >= snr_threshold
        if not keep.any():
            # Calibrating INT8 ranges on all-silent data would be silently wrong.
            raise ValueError("All calibration chunks were filtered as silent.")
        x = x[keep]
    return x.astype(np.float32)


def stratified_sample_paths(paths: list[str], labels: list[str], per_class: int,
                            seed: int = 0) -> list[str]:
    """Up to `per_class` seeded draws from each class's files, shuffled."""
    rng = np.random.default_rng(seed)
    by_class: dict[str, list[str]] = {}
    for p, label in zip(paths, labels):
        by_class.setdefault(label, []).append(p)
    out = []
    for _, files in sorted(by_class.items()):
        take = min(per_class, len(files))
        out.extend(rng.choice(files, size=take, replace=False).tolist())
    rng.shuffle(out)
    return out
