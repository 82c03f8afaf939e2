"""Batched spectrogram features (port of ops/spectrogram.py::spectrogram_batch).

Maps [B, T] waveforms to [B, bins, W] features with the reference's mode x
mag_scale behaviour matrix and normalization placement. This slice ports
the 'linear', 'mel' and 'log_mel' modes with mag_scale 'none' | 'pwl' |
'db' in float32; 'mfcc' and 'pcen' wait for a later slice (ROADMAP.md,
Queue 1 item 2).
"""

from __future__ import annotations

import functools

import torch

from birdnet_stm32_tpu_torch.ops import magnitude as mag_ops
from birdnet_stm32_tpu_torch.ops.mel import mel_filterbank
from birdnet_stm32_tpu_torch.ops.stft import stft_magnitude

VALID_MODES = ("mel", "mfcc", "log_mel", "linear")
_SAMPLE_DIMS = (1, 2)


@functools.lru_cache(maxsize=16)
def _mel_fb(sample_rate: int, n_fft: int, mel_bins: int,
            device: torch.device) -> torch.Tensor:
    # fmax floors like the reference (sample_rate // 2) so odd sample rates
    # produce identical band edges.
    fb = mel_filterbank(sample_rate, n_fft, mel_bins, fmin=150.0,
                        fmax=float(sample_rate // 2))
    return torch.from_numpy(fb).to(device)


def spectrogram_batch(audio: torch.Tensor, sample_rate: int = 24000,
                      n_fft: int = 512, mel_bins: int = 64, spec_width: int = 256,
                      mag_scale: str = "none", mode: str = "mel",
                      n_mfcc: int = 20) -> torch.Tensor:
    """[B, T] float32 waveforms -> [B, bins, spec_width] features in [0, 1].

    Args:
        audio: [B, T] mono waveforms.
        sample_rate: Sample rate in Hz.
        n_fft: FFT size.
        mel_bins: Mel band count; <= 0 selects linear STFT bins.
        spec_width: Output frame count W (hop = T // W).
        mag_scale: 'none' | 'pwl' | 'db' ('pcen' is not ported yet).
        mode: 'mel' | 'log_mel' | 'linear' ('mfcc' is not ported yet).
        n_mfcc: Accepted for signature parity with the JAX function.
    """
    if mode not in VALID_MODES:
        raise ValueError(f"Invalid mode: {mode!r}")
    if mode == "mfcc" or mag_scale == "pcen":
        raise NotImplementedError(
            f"spectrogram_batch mode={mode!r} mag_scale={mag_scale!r} is not "
            "ported yet (ROADMAP.md, Queue 1 item 2: mfcc and pcen)")
    B, T = audio.shape
    # hop = T // spec_width; spec_width <= 0 means "all frames" at n_fft//2
    # (the reference's explicit fallback).
    hop = max(1, T // spec_width) if spec_width > 0 else n_fft // 2
    n_frames_full = 1 + T // hop
    n_frames = n_frames_full if spec_width <= 0 else min(spec_width, n_frames_full)

    S = stft_magnitude(audio, n_fft=n_fft, hop=hop, n_frames=n_frames)  # [B, W, F]
    if not (mel_bins <= 0 or mode == "linear"):
        S = S @ _mel_fb(sample_rate, n_fft, mel_bins, audio.device)  # [B, W, M]
    S = S.transpose(1, 2)  # [B, bins, W] freq-major

    if mode == "log_mel":
        return mag_ops.normalize_minmax(torch.log1p(S), dim=_SAMPLE_DIMS)

    # 'mel' and 'linear' modes share the mag_scale behaviour matrix.
    if mag_scale == "pwl":
        S = mag_ops.pwl_compress(mag_ops.normalize_minmax(S, dim=_SAMPLE_DIMS))
    elif mag_scale == "db":
        ref = S.amax(dim=_SAMPLE_DIMS, keepdim=True)
        S = mag_ops.amplitude_to_db(S, ref=ref, top_db=80.0, dim=_SAMPLE_DIMS)
    return mag_ops.normalize_minmax(S, dim=_SAMPLE_DIMS)
