"""Waveform batch -> model-input batch (port of ops/frontend.py).

- librosa -> mel spectrogram with the configured mag_scale, [B, M, W, 1]
- mfcc    -> MFCC features (mag_scale forced to 'none'),    [B, n_mfcc, W, 1]
- log_mel -> log1p mel (mag_scale forced to 'none'),        [B, M, W, 1]
- hybrid  -> linear |STFT| normalized to [0, 1],            [B, F, W, 1]
- raw     -> peak-normalized waveform,                      [B, T, 1]

This is the composition: serving computes the spectrogram frontends with
the fused kernel (ops/kernels/frontend_kernel.py) and comes here only for
what that kernel's dispatch excludes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.ops.spectrogram import spectrogram_batch


def waveform_to_input(audio: torch.Tensor, audio_frontend: str, sample_rate: int,
                      n_fft: int, mel_bins: int, spec_width: int, mag_scale: str,
                      n_mfcc: int, chunk_samples: int, stft_precision: str = "highest",
                      feature_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Map [B, T] waveforms to the model input for the given frontend.

    feature_dtype=torch.bfloat16 emits bf16 features (the bf16-I/O STFT
    with stft_precision 'high' or 'default'; the raw frontend casts)."""
    if audio_frontend == "raw":
        x = audio[:, :chunk_samples]
        if x.shape[1] < chunk_samples:
            x = F.pad(x, (0, chunk_samples - x.shape[1]))
        peak = x.abs().amax(dim=1, keepdim=True)
        x = (x / (peak + 1e-6))[..., None]  # [B, T, 1]
        return x if feature_dtype is None else x.to(feature_dtype)

    spec = dict(sample_rate=sample_rate, n_fft=n_fft, spec_width=spec_width,
                stft_precision=stft_precision, feature_dtype=feature_dtype)
    if audio_frontend == "hybrid":
        S = spectrogram_batch(audio, mel_bins=-1, mag_scale="none", mode="linear", **spec)
    elif audio_frontend in ("mfcc", "log_mel"):
        S = spectrogram_batch(audio, mel_bins=mel_bins, mag_scale="none",
                              mode=audio_frontend, n_mfcc=n_mfcc, **spec)
    elif audio_frontend == "librosa":
        S = spectrogram_batch(audio, mel_bins=mel_bins, mag_scale=mag_scale, mode="mel",
                              **spec)
    else:
        raise ValueError(f"Invalid audio frontend: {audio_frontend!r}")
    return S[..., None]  # [B, bins, W, 1]


def inputs_for_config(audio: torch.Tensor, cfg: ModelConfig,
                      stft_precision: str = "highest",
                      feature_dtype: torch.dtype | None = None) -> torch.Tensor:
    """waveform_to_input with the geometry of a ModelConfig.

    stft_precision: 'highest' (the default) | 'high' | 'default'
    (ops/stft.py). feature_dtype: None (float32) | torch.bfloat16 (bf16
    serving: the bf16-I/O STFT under 'high' or 'default')."""
    return waveform_to_input(
        audio,
        audio_frontend=cfg.audio_frontend,
        sample_rate=cfg.sample_rate,
        n_fft=cfg.fft_length,
        mel_bins=cfg.num_mels,
        spec_width=cfg.spec_width,
        mag_scale=cfg.mag_scale,
        n_mfcc=cfg.n_mfcc,
        chunk_samples=cfg.chunk_samples,
        stft_precision=stft_precision,
        feature_dtype=feature_dtype,
    )
