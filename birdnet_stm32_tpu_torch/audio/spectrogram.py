"""Host convenience spectrogram API (port of audio/spectrogram.py): the
reference's single-sample signatures over the batched
ops/spectrogram.py::spectrogram_batch (the composition), on the card
unless the caller passes device="cpu"::

    from birdnet_stm32_tpu_torch.audio.spectrogram import get_spectrogram_from_audio
"""

from __future__ import annotations

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.ops.spectrogram import VALID_MODES, spectrogram_batch

__all__ = ["VALID_MODES", "get_spectrogram_from_audio", "normalize"]


def normalize(S: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0, 1]."""
    S = np.asarray(S)
    return (S - S.min()) / (S.max() - S.min() + 1e-10)


def get_spectrogram_from_audio(
    audio: np.ndarray,
    sample_rate: int = 24000,
    n_fft: int = 512,
    mel_bins: int = 64,
    spec_width: int = 256,
    mag_scale: str = "none",
    mode: str = "mel",
    n_mfcc: int = 20,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """One mono waveform -> a numpy [bins, spec_width] array in [0, 1],
    frequency-major: the batched pipeline on a batch of one, on `device`."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim != 1:
        raise ValueError(f"expected 1D mono audio, got shape {audio.shape}")
    dev = resolve_device(device)
    with torch.no_grad(), full_fp32():
        out = spectrogram_batch(torch.from_numpy(audio)[None].to(dev), sample_rate=sample_rate,
                                n_fft=n_fft, mel_bins=mel_bins, spec_width=spec_width,
                                mag_scale=mag_scale, mode=mode, n_mfcc=n_mfcc)
    return out[0].cpu().numpy()
