"""The ingress and the spectrogram frontend, in numpy float64.

- int16 ingress: [B, T + 1] int16 codes with a scale column -> codes /
  max(|scale|, 1);
- a batch at another rate than the model's: scipy's resample_poly (Kaiser
  5.0 low-pass), then padded or cut to the model's chunk length;
- the hybrid frontend's input: the |STFT| of the centre-padded waveform
  (periodic Hann window, hop = T // spec_width, spec_width frames), min-max
  normalised over each sample's bins and frames, [B, n_fft // 2 + 1,
  spec_width, 1] float32.
"""

from __future__ import annotations

from math import gcd

import numpy as np

ROW_BLOCK = 16


def dequantize(batch: np.ndarray, input_dtype: str | None) -> np.ndarray:
    if input_dtype == "int16":
        codes = batch[:, :-1].astype(np.float64)
        scale = np.maximum(np.abs(batch[:, -1:].astype(np.float64)), 1.0)
        return codes / scale
    if input_dtype in (None, "float32"):
        return batch.astype(np.float64)
    raise ValueError(f"no reference for input_dtype {input_dtype!r}")


def resample(wave: np.ndarray, rate_in: int, rate_out: int, length: int) -> np.ndarray:
    if rate_in == rate_out:
        out = wave
    else:
        from scipy.signal import resample_poly

        g = gcd(rate_in, rate_out)
        out = resample_poly(wave, rate_out // g, rate_in // g, axis=-1)
    if out.shape[1] < length:
        out = np.pad(out, ((0, 0), (0, length - out.shape[1])))
    return out[:, :length]


def linear_features(wave: np.ndarray, n_fft: int, spec_width: int) -> np.ndarray:
    """[B, T] -> [B, n_fft // 2 + 1, spec_width, 1] float32 in [0, 1]."""
    B, T = wave.shape
    hop = max(1, T // spec_width)
    n_frames = min(spec_width, 1 + T // hop)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    out = np.empty((B, n_fft // 2 + 1, n_frames, 1), np.float32)
    for i in range(0, B, ROW_BLOCK):
        y = np.pad(wave[i:i + ROW_BLOCK], ((0, 0), (n_fft // 2, n_fft // 2)))
        need = (n_frames - 1) * hop + n_fft
        if need > y.shape[1]:
            y = np.pad(y, ((0, 0), (0, need - y.shape[1])))
        idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        S = np.abs(np.fft.rfft(y[:, idx] * win, axis=-1)).transpose(0, 2, 1)  # [b, F, W]
        lo = S.min(axis=(1, 2), keepdims=True)
        hi = S.max(axis=(1, 2), keepdims=True)
        out[i:i + ROW_BLOCK, :, :, 0] = (S - lo) / (hi - lo + 1e-10)
    return out


def features(batch: np.ndarray, model: dict, traffic: dict) -> np.ndarray:
    """A request's input batch as the traffic ships it -> the model's input
    features, for the configuration's `model` geometry."""
    if model["audio_frontend"] != "hybrid":
        raise ValueError(f"no reference for frontend {model['audio_frontend']!r}")
    rate = model["sample_rate"]
    length = int(rate * model["chunk_duration"])
    wave = dequantize(batch, traffic.get("input_dtype"))
    wave = resample(wave, traffic.get("input_rate") or rate, rate, length)
    return linear_features(wave, model["fft_length"], model["spec_width"])
