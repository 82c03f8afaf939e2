"""In-graph audio frontends as nn.Modules (port of models/frontend_layer.py).

Modes:
- precomputed: [B, bins, T, 1] -> slice to spec_width.
- hybrid: [B, fft_bins, W, 1] linear |STFT| -> mel mixer matmul (the
  Slaney-seeded `mel_mixer`, or with learn_mel_scale the triangles of
  `tri_mel_matrix` over the learnable `mel_seg_logits`) -> ReLU ->
  per-sample max-normalize -> magnitude scaling -> [B, mel_bins, W, 1].
- raw: [B, T, 1] -> symmetric pad -> strided conv1d filterbank `raw_fb`
  (k=16, stride=ceil(T/W), no bias) -> BN `raw_fb_bn` -> ReLU6 ->
  magnitude scaling -> [B, mel_bins, W, 1].

`raw_fb_bn` follows the module's train / eval mode (models/blocks.py:
batch statistics and the Keras running-statistics update in train mode).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from birdnet_stm32_tpu_torch.models.blocks import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm1d,
    promote,
    relu6,
)
from birdnet_stm32_tpu_torch.ops.magnitude import db_compress
from birdnet_stm32_tpu_torch.ops.mel import hz_to_mel, mel_filterbank

# Default pwl / pcen constants (reference magnitude.py:53-134).
_PWL_K0 = 0.40
_PWL_THRESHOLDS = (0.10, 0.35, 0.65)
_PWL_SLOPES = (0.25, 0.15, 0.08)
_PCEN_AGC = 0.6
_PCEN_K1 = 0.15
_PCEN_SHIFT = -0.2
_PCEN_K2MK1 = 0.45
RAW_KERNEL = 16

# Canonical frontend -> in-graph frontend mode (the JAX registry's built-ins).
_FRONTEND_MODES = {"librosa": "precomputed", "mfcc": "precomputed",
                   "log_mel": "precomputed", "hybrid": "hybrid", "raw": "raw"}


class MagnitudeScaling(nn.Module):
    """Per-channel magnitude compression over [..., C]: 'none' | 'pwl' |
    'pcen' | 'db'.

    Parameters are per-channel vectors named as the Flax module names them
    (pwl_k0, pwl_shift{i}_w, pwl_shift{i}_b, pwl_k{i}; pcen_agc, pcen_k1,
    pcen_shift_w, pcen_shift_b, pcen_k2mk1).
    """

    def __init__(self, method: str = "pwl", channels: int = 64):
        super().__init__()
        if method not in ("none", "pwl", "pcen", "db"):
            raise ValueError(f"Invalid mag_scale: {method!r}")
        self.method = method
        if method == "pwl":
            self.pwl_k0 = nn.Parameter(torch.full((channels,), _PWL_K0))
            for i, (t, slope) in enumerate(zip(_PWL_THRESHOLDS, _PWL_SLOPES), start=1):
                setattr(self, f"pwl_shift{i}_w", nn.Parameter(torch.ones(channels)))
                setattr(self, f"pwl_shift{i}_b", nn.Parameter(torch.full((channels,), -t)))
                setattr(self, f"pwl_k{i}", nn.Parameter(torch.full((channels,), slope)))
        elif method == "pcen":
            # The reference's pcen approximation (magnitude.py:166-177): its
            # "EMA" pools are 1x1 identity average-pools, so the smoother is x.
            self.pcen_agc = nn.Parameter(torch.full((channels,), _PCEN_AGC))
            self.pcen_k1 = nn.Parameter(torch.full((channels,), _PCEN_K1))
            self.pcen_shift_w = nn.Parameter(torch.ones(channels))
            self.pcen_shift_b = nn.Parameter(torch.full((channels,), _PCEN_SHIFT))
            self.pcen_k2mk1 = nn.Parameter(torch.full((channels,), _PCEN_K2MK1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "none":
            return x
        if self.method == "db":
            return db_compress(x)
        if self.method == "pcen":
            y0 = torch.relu(x - self.pcen_agc * x)
            b2 = self.pcen_k2mk1 * torch.relu(self.pcen_shift_w * y0 + self.pcen_shift_b)
            return torch.relu(self.pcen_k1 * y0 + b2)
        y = self.pwl_k0 * x
        for i in range(1, len(_PWL_THRESHOLDS) + 1):
            w = getattr(self, f"pwl_shift{i}_w")
            b = getattr(self, f"pwl_shift{i}_b")
            y = y + getattr(self, f"pwl_k{i}") * torch.relu(w * x + b)
        return y


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus as jax.nn.softplus computes it, logaddexp(x, 0):
    max(x, 0) + log1p(exp(-|x|)), each operation rounded to x's dtype."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _running_sums(v: torch.Tensor) -> list[torch.Tensor]:
    """[0, v0, v0 + v1, ...] added in index order in v's dtype. XLA's CPU
    reduce and cumsum add up to 17 values so (torch's CPU cumsum
    accumulates in float64); past that XLA vectorizes them, and one float32
    ulp of a breakpoint (~50 mel) moves the triangles by up to ~2e-5."""
    run = [v.new_zeros(())]
    for k in range(v.shape[0]):
        run.append(run[-1] + v[k])
    return run


def tri_mel_matrix(seg_logits: torch.Tensor, sample_rate: int, fft_length: int,
                   mel_bins: int) -> torch.Tensor:
    """[F, M] float32 triangular mel weights from learnable segment logits
    [M+1] (the JAX package's tri_mel_matrix).

    Softplus segment widths normalized over the [150 Hz, sr//2] Slaney-mel
    range, cumsum to M+2 breakpoints, triangles evaluated at the FFT bins'
    mel positions, column-normalized. Zero logits give near-uniform mel
    spacing.

    The dtypes are JAX's: the segment widths, their normalisation and their
    cumsum compute in the logits' dtype (the sum in float32, rounded back),
    then the breakpoints are float32 (the concatenation with a float32 zero
    promotes them), and so is everything after. bf16 logits therefore give
    a float32 matrix of bf16-rounded breakpoints.
    """
    eps = 1e-6
    freqs = np.linspace(0.0, sample_rate / 2.0, fft_length // 2 + 1)
    bins_mel = torch.as_tensor(hz_to_mel(freqs), dtype=torch.float32,
                               device=seg_logits.device)  # [F]
    mel_fmin = float(hz_to_mel(150.0))
    mel_fmax = float(hz_to_mel(float(sample_rate // 2)))  # floors, as the reference

    # Constants in the logits' dtype, as JAX's weak-typed Python scalars.
    const = seg_logits.new_tensor
    seg = _softplus(seg_logits) + const(1e-3)  # [M+1]
    total = _running_sums(seg.float())[-1].to(seg.dtype)
    seg = seg / (total + const(eps)) * const(mel_fmax - mel_fmin)
    p_full = mel_fmin + torch.stack(_running_sums(seg)).float()  # [M+2]
    M = mel_bins
    left, center, right = p_full[:M], p_full[1: M + 1], p_full[2: M + 2]
    up = (bins_mel[:, None] - left[None, :]) / torch.clamp(center - left, min=eps)
    down = (right[None, :] - bins_mel[:, None]) / torch.clamp(right - center, min=eps)
    tri = torch.clamp(torch.minimum(up, down), min=0.0)  # [F, M]
    return tri / (tri.sum(dim=0, keepdim=True) + eps)


class AudioFrontend(nn.Module):
    """In-graph frontend producing [B, mel_bins, W, 1]: 'precomputed' |
    'hybrid' | 'raw'."""

    def __init__(self, mode: str, mel_bins: int = 64, spec_width: int = 256,
                 sample_rate: int = 24000, chunk_duration: float = 3.0,
                 fft_length: int = 512, mag_scale: str = "pwl",
                 learn_mel_scale: bool = False):
        super().__init__()
        if mode not in ("precomputed", "hybrid", "raw"):
            raise ValueError(f"Invalid frontend mode: {mode!r}")
        self.mode = mode
        self.mel_bins = mel_bins
        self.spec_width = spec_width
        self.sample_rate = sample_rate
        self.fft_length = fft_length
        self.fft_bins = fft_length // 2 + 1
        self.learn_mel_scale = learn_mel_scale and mode == "hybrid"
        if mode == "hybrid":
            if self.learn_mel_scale:
                self.mel_seg_logits = nn.Parameter(torch.zeros(mel_bins + 1))
            else:
                # Slaney mel basis seed (reference frontend.py:257-276).
                fb = mel_filterbank(sample_rate, fft_length, mel_bins, fmin=150.0,
                                    fmax=float(sample_rate // 2))
                self.mel_mixer = nn.Parameter(torch.from_numpy(fb))  # [F, M]
        elif mode == "raw":
            T = int(sample_rate * chunk_duration)
            self.raw_samples = T
            self.raw_stride = int(math.ceil(T / float(spec_width)))
            total = max(0, self.raw_stride * (spec_width - 1) + RAW_KERNEL - T)
            self.raw_pad = (total // 2, total - total // 2)
            self.raw_fb = nn.Conv1d(1, mel_bins, RAW_KERNEL, stride=self.raw_stride,
                                    bias=False)
            self.raw_fb_bn = BatchNorm1d(mel_bins, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        if mode != "precomputed":
            self.mag = MagnitudeScaling(mag_scale, mel_bins)

    def mixer(self) -> torch.Tensor:
        """The hybrid mel mixer [F, M]: the parameter, or with
        learn_mel_scale the float32 triangles of the segment logits."""
        if self.learn_mel_scale:
            return tri_mel_matrix(self.mel_seg_logits, self.sample_rate, self.fft_length,
                                  self.mel_bins)
        return self.mel_mixer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "precomputed":
            return x[:, :, : self.spec_width, :]
        if self.mode == "hybrid":
            if x.dim() != 4 or x.shape[1] != self.fft_bins:
                raise ValueError(f"Hybrid expects [B,{self.fft_bins},W,1], got "
                                 f"{tuple(x.shape)}")
            y = x[:, :, : self.spec_width, 0].transpose(1, 2)  # [B, W, F]
            # Full-precision accumulation (callers hold TF32 and bf16
            # reduced-precision reductions off), as the reference's HIGHEST;
            # bf16 features times a float32 mixer give float32.
            y, mixer = promote(y, self.mixer())
            y = torch.relu(y @ mixer)  # [B, W, M]
            y = y / (y.amax(dim=(1, 2), keepdim=True) + 1e-6)
        else:  # raw: [B, T, 1] -> [B, W, M]
            y = F.pad(x[:, : self.raw_samples, 0], self.raw_pad)[:, None]  # [B, 1, T']
            # The frontend opts out of the activation fake-quant hook.
            y = relu6(self.raw_fb_bn(self.raw_fb(y)), hookable=False).transpose(1, 2)
        y = self.mag(y)
        return y.transpose(1, 2)[..., None]  # [B, M, W, 1]


def make_audio_frontend(audio_frontend: str, num_mels: int, spec_width: int,
                        sample_rate: int, chunk_duration: float, fft_length: int,
                        mag_scale: str, n_mfcc: int,
                        learn_mel_scale: bool = False) -> AudioFrontend:
    """The in-graph frontend of a configuration's canonical frontend name,
    as every model of the port builds it ('audio_frontend'): precomputed
    features (librosa, mfcc, log_mel) are sliced to spec_width, hybrid and
    raw compute their mel channels with `mag_scale`."""
    if audio_frontend not in _FRONTEND_MODES:
        raise ValueError(f"Invalid audio frontend: {audio_frontend!r}")
    mode = _FRONTEND_MODES[audio_frontend]
    input_bins = n_mfcc if audio_frontend == "mfcc" else num_mels
    return AudioFrontend(
        mode, mel_bins=input_bins if mode == "precomputed" else num_mels,
        spec_width=spec_width, sample_rate=sample_rate,
        chunk_duration=chunk_duration, fft_length=fft_length,
        mag_scale=mag_scale if mode != "precomputed" else "none",
        learn_mel_scale=learn_mel_scale)
