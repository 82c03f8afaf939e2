"""In-graph audio frontends as nn.Modules (port of models/frontend_layer.py).

Modes:
- precomputed: [B, bins, T, 1] -> slice to spec_width.
- hybrid: [B, fft_bins, W, 1] linear |STFT| -> mel mixer matmul -> ReLU ->
  per-sample max-normalize -> magnitude scaling -> [B, mel_bins, W, 1].

The 'raw' learned filterbank, the learnable mel breakpoints and the 'pcen'
scaling wait for a later slice (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from birdnet_stm32_tpu_torch.ops.magnitude import db_compress
from birdnet_stm32_tpu_torch.ops.mel import mel_filterbank

# Default pwl constants (reference magnitude.py:53-134).
_PWL_K0 = 0.40
_PWL_THRESHOLDS = (0.10, 0.35, 0.65)
_PWL_SLOPES = (0.25, 0.15, 0.08)


class MagnitudeScaling(nn.Module):
    """Per-channel magnitude compression over [..., C]: 'none' | 'pwl' | 'db'.

    Parameters are per-channel vectors named as the Flax module names them
    (pwl_k0, pwl_shift{i}_w, pwl_shift{i}_b, pwl_k{i}).
    """

    def __init__(self, method: str = "pwl", channels: int = 64):
        super().__init__()
        if method not in ("none", "pwl", "db"):
            raise NotImplementedError(
                f"MagnitudeScaling({method!r}) is not ported yet (ROADMAP.md, "
                "Queue 1 item 5)")
        self.method = method
        if method == "pwl":
            self.pwl_k0 = nn.Parameter(torch.full((channels,), _PWL_K0))
            for i, (t, slope) in enumerate(zip(_PWL_THRESHOLDS, _PWL_SLOPES), start=1):
                setattr(self, f"pwl_shift{i}_w", nn.Parameter(torch.ones(channels)))
                setattr(self, f"pwl_shift{i}_b", nn.Parameter(torch.full((channels,), -t)))
                setattr(self, f"pwl_k{i}", nn.Parameter(torch.full((channels,), slope)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "none":
            return x
        if self.method == "db":
            return db_compress(x)
        y = self.pwl_k0 * x
        for i in range(1, len(_PWL_THRESHOLDS) + 1):
            w = getattr(self, f"pwl_shift{i}_w")
            b = getattr(self, f"pwl_shift{i}_b")
            y = y + getattr(self, f"pwl_k{i}") * torch.relu(w * x + b)
        return y


class AudioFrontend(nn.Module):
    """In-graph frontend producing [B, mel_bins, W, 1]: 'precomputed' | 'hybrid'."""

    def __init__(self, mode: str, mel_bins: int = 64, spec_width: int = 256,
                 sample_rate: int = 24000, fft_length: int = 512,
                 mag_scale: str = "pwl"):
        super().__init__()
        if mode not in ("precomputed", "hybrid"):
            raise NotImplementedError(
                f"AudioFrontend mode {mode!r} is not ported yet (ROADMAP.md, "
                "Queue 1 item 5)")
        self.mode = mode
        self.spec_width = spec_width
        self.fft_bins = fft_length // 2 + 1
        if mode == "hybrid":
            # Slaney mel basis seed (reference frontend.py:257-276).
            fb = mel_filterbank(sample_rate, fft_length, mel_bins, fmin=150.0,
                                fmax=float(sample_rate // 2))
            self.mel_mixer = nn.Parameter(torch.from_numpy(fb))  # [F, M]
            self.mag = MagnitudeScaling(mag_scale, mel_bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "precomputed":
            return x[:, :, : self.spec_width, :]
        if x.dim() != 4 or x.shape[1] != self.fft_bins:
            raise ValueError(f"Hybrid expects [B,{self.fft_bins},W,1], got {tuple(x.shape)}")
        y = x[:, :, : self.spec_width, 0].transpose(1, 2)  # [B, W, F]
        # Full float32 (callers hold TF32 off), as the reference's HIGHEST.
        y = torch.relu(y @ self.mel_mixer)  # [B, W, M]
        y = y / (y.amax(dim=(1, 2), keepdim=True) + 1e-6)
        y = self.mag(y)
        return y.transpose(1, 2)[..., None]  # [B, M, W, 1]
