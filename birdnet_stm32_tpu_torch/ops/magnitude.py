"""Magnitude compression curves and dB helpers (port of ops/magnitude.py).

Elementwise math over [..., F, W] spectrograms, and pcen's smoother along
the last (time) axis.
"""

from __future__ import annotations

import numpy as np
import torch

# PWL default breakpoints/slopes (reference: audio/spectrogram.py:141-144).
PWL_THRESHOLDS = (0.10, 0.35, 0.65)
PWL_SLOPES = (0.40, 0.25, 0.15, 0.08)


def _amin(S: torch.Tensor, dim) -> torch.Tensor:
    return S.amin() if dim is None else S.amin(dim=dim, keepdim=True)


def _amax(S: torch.Tensor, dim) -> torch.Tensor:
    return S.amax() if dim is None else S.amax(dim=dim, keepdim=True)


def normalize_minmax(S: torch.Tensor, dim=None) -> torch.Tensor:
    """Min-max normalize to [0, 1]; `dim` None reduces over the whole tensor
    (per-sample callers pass the non-batch dims)."""
    s_min, s_max = _amin(S, dim), _amax(S, dim)
    return (S - s_min) / (s_max - s_min + 1e-10)


def pwl_compress(S: torch.Tensor) -> torch.Tensor:
    """y = k0*x + sum_i k_i * relu(x - t_i) on a [0, 1]-normalized input."""
    y = PWL_SLOPES[0] * S
    for t, k in zip(PWL_THRESHOLDS, PWL_SLOPES[1:]):
        y = y + k * torch.relu(S - t)
    return y


def power_to_db(S: torch.Tensor, ref: torch.Tensor | float = 1.0,
                amin: float = 1e-10, top_db: float | None = 80.0,
                dim=None) -> torch.Tensor:
    """10*log10(S/ref) with clamping, matching librosa.power_to_db; the
    top_db clamp takes its max over `dim` (one sample)."""
    ref = torch.as_tensor(ref, dtype=S.dtype, device=S.device)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, _amax(log_spec, dim) - top_db)
    return log_spec


def amplitude_to_db(S: torch.Tensor, ref: torch.Tensor | float = 1.0,
                    amin: float = 1e-5, top_db: float | None = 80.0,
                    dim=None) -> torch.Tensor:
    """20*log10(S/ref), matching librosa.amplitude_to_db (ref applied squared)."""
    ref = torch.as_tensor(ref, dtype=S.dtype, device=S.device)
    return power_to_db(torch.square(S), ref=torch.square(ref), amin=amin * amin,
                       top_db=top_db, dim=dim)


def db_compress(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In-graph dB curve: 10*log10(max(x, eps))."""
    return 10.0 * torch.log10(torch.clamp(x, min=eps))


def pcen_coefficients(sr: int, hop_length: int,
                      time_constant: float = 0.400) -> tuple[float, float]:
    """(1 - b, b) of pcen's EMA smoother, rounded as the JAX package rounds
    them: t_frames in float64, the rest in float32 arithmetic."""
    t_frames = time_constant * sr / float(hop_length)
    b = ((np.sqrt(np.float32(1.0 + 4.0 * t_frames**2)) - np.float32(1.0))
         / np.float32(2.0 * t_frames**2))
    return float(np.float32(1.0) - b), float(b)


def pcen(S: torch.Tensor, sr: int, hop_length: int, gain: float = 0.98,
         bias: float = 2.0, power: float = 0.5, time_constant: float = 0.400,
         eps: float = 1e-6) -> torch.Tensor:
    """Per-channel energy normalization over [..., F, T], librosa.pcen's
    defaults.

    The smoother m[t] = (1-b)*m[t-1] + b*S[t] starts at m[0] = S[0]
    (scipy's lfilter_zi convention) and runs sequentially over frames, in
    the order the CUDA kernel runs it; the JAX package evaluates the same
    recurrence with an associative scan.
    """
    a, b = pcen_coefficients(sr, hop_length, time_constant)
    M = torch.empty_like(S)
    m = S[..., 0]
    M[..., 0] = m
    for t in range(1, S.shape[-1]):
        m = a * m + b * S[..., t]
        M[..., t] = m
    log_eps = float(np.log(np.float32(eps)))
    smooth = torch.exp(-gain * (log_eps + torch.log1p(M / eps)))
    return float(np.float32(bias**power)) * torch.expm1(power * torch.log1p(S * smooth / bias))
