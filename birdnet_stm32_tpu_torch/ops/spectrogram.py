"""Batched spectrogram features (port of ops/spectrogram.py::spectrogram_batch).

Maps [B, T] waveforms to [B, bins, W] features with the reference's mode x
mag_scale behaviour matrix and normalization placement: modes 'linear',
'mel', 'log_mel' and 'mfcc', mag_scale 'none' | 'pwl' | 'db' | 'pcen'.
`spectrogram_epilogue` is everything after the |STFT|; the fused kernel's
plain version (ops/kernels/frontend_kernel.py) shares it. With
feature_dtype=torch.bfloat16 the |STFT| (and the mel product) come in
bf16, the epilogue computes in float32 and the features are bf16, as in
the JAX package.
"""

from __future__ import annotations

import functools

import torch

from birdnet_stm32_tpu_torch.ops import magnitude as mag_ops
from birdnet_stm32_tpu_torch.ops.dct import dct2_ortho
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


def spectrogram_epilogue(S: torch.Tensor, mode: str, mag_scale: str,
                         sample_rate: int, n_fft: int, hop: int, mel_bins: int,
                         n_mfcc: int, out_w: int) -> torch.Tensor:
    """[B, W, F] |STFT| -> [B, bins, out_w] features in [0, 1].

    mfcc squares the magnitude before the mel product, takes power_to_db's
    ref and top_db over all W frames and keeps the first out_w frames after
    the DCT; every other mode expects W == out_w. log_mel and mfcc ignore
    mag_scale, as in the reference. A bf16 S takes the mel product in bf16
    and the rest in float32; the result is float32.
    """
    if not (mel_bins <= 0 or mode == "linear"):
        if mode == "mfcc":
            S = torch.square(S)
        S = S @ _mel_fb(sample_rate, n_fft, mel_bins, S.device).to(S.dtype)  # [B, W, M]
    S = S.transpose(1, 2).float()  # [B, bins, W] freq-major

    if mode == "mfcc":
        ref = S.amax(dim=_SAMPLE_DIMS, keepdim=True)
        S = mag_ops.power_to_db(S, ref=ref, top_db=80.0, dim=_SAMPLE_DIMS)
        S = dct2_ortho(S.transpose(1, 2), n_mfcc).transpose(1, 2)  # DCT over mels
        return mag_ops.normalize_minmax(S[:, :, :out_w], dim=_SAMPLE_DIMS)

    if mode == "log_mel":
        return mag_ops.normalize_minmax(torch.log1p(S), dim=_SAMPLE_DIMS)

    # 'mel' and 'linear' modes share the mag_scale behaviour matrix.
    if mag_scale == "pcen":
        S = mag_ops.pcen(S * (2.0**31), sr=sample_rate, hop_length=hop)
    elif mag_scale == "pwl":
        S = mag_ops.pwl_compress(mag_ops.normalize_minmax(S, dim=_SAMPLE_DIMS))
    elif mag_scale == "db":
        ref = S.amax(dim=_SAMPLE_DIMS, keepdim=True)
        S = mag_ops.amplitude_to_db(S, ref=ref, top_db=80.0, dim=_SAMPLE_DIMS)
    return mag_ops.normalize_minmax(S, dim=_SAMPLE_DIMS)


def spectrogram_batch(audio: torch.Tensor, sample_rate: int = 24000,
                      n_fft: int = 512, mel_bins: int = 64, spec_width: int = 256,
                      mag_scale: str = "none", mode: str = "mel",
                      n_mfcc: int = 20, stft_precision: str = "highest",
                      feature_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, T] float32 waveforms -> [B, bins, spec_width] features in [0, 1].

    Args:
        audio: [B, T] mono waveforms.
        sample_rate: Sample rate in Hz.
        n_fft: FFT size.
        mel_bins: Mel band count; <= 0 selects linear STFT bins.
        spec_width: Output frame count W (hop = T // W).
        mag_scale: 'none' | 'pcen' | 'pwl' | 'db' (mel/linear modes only).
        mode: 'mel' | 'mfcc' | 'log_mel' | 'linear'.
        n_mfcc: Coefficients kept in mfcc mode.
        stft_precision: ops/stft.py's precision ('highest' | 'high' |
            'default').
        feature_dtype: None keeps float32. torch.bfloat16 emits bf16
            features through the bf16-I/O STFT (with precision 'high' or
            'default'); mfcc keeps the float32 pipeline and only casts.
    """
    if mode not in VALID_MODES:
        raise ValueError(f"Invalid mode: {mode!r}")
    if mode == "mfcc" and mel_bins <= 0:
        raise ValueError("mfcc mode needs mel_bins > 0 (DCT runs over mel bands)")
    B, T = audio.shape
    # hop = T // spec_width; spec_width <= 0 means "all frames" at n_fft//2
    # (the reference's explicit fallback).
    hop = max(1, T // spec_width) if spec_width > 0 else n_fft // 2
    # librosa (center=True) yields 1 + T//hop frames; the reference slices
    # to spec_width before any stats except in mfcc mode, where
    # power_to_db's ref/top_db max runs over the full frame count.
    n_frames_full = 1 + T // hop
    if mode == "mfcc" or spec_width <= 0:
        n_frames = n_frames_full
    else:
        n_frames = min(spec_width, n_frames_full)
    out_w = min(spec_width, n_frames) if spec_width > 0 else n_frames

    S = stft_magnitude(audio, n_fft=n_fft, hop=hop, n_frames=n_frames,
                       precision=stft_precision,
                       out_dtype=None if mode == "mfcc" else feature_dtype)  # [B, W, F]
    S = spectrogram_epilogue(S, mode, mag_scale, sample_rate, n_fft, hop,
                             mel_bins, n_mfcc, out_w)
    return S if feature_dtype is None else S.to(feature_dtype)
