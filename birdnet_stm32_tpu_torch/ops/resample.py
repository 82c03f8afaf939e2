"""Polyphase resampling on the device (port of ops/resample.py).

`scipy.signal.resample_poly` semantics: zero-stuff by `up`, Kaiser-windowed
sinc FIR low-pass, keep every `down`-th sample. The JAX package computes
this as one XLA convolution with `lhs_dilation=up`. `conv1d` has no input
dilation, and zero-stuffing the input would build a signal `up` times
longer (147x for a 48 kHz source), so the port splits the filter into its
`up` polyphase branches instead. Output j = r + up*i of branch r reads the
taps h[p_r + m*up] (p_r = (r*down + half_len) mod up) against the inputs
x[c_r + i*down - m] (c_r = (r*down + half_len) // up): a strided
correlation of x with ceil(n_taps/up) taps, shifted by c_r. All branches
run as one `conv1d` with `up` output channels, stride `down` and a kernel
of ceil(n_taps/up) + c_{up-1} - c_0 taps, each branch's taps placed at its
own shift (the rest of the row is zero).

Filter design happens once on the host with scipy's `firwin`, the filter
`resample_poly` designs. The convolution runs in float32 with TF32 off.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from birdnet_stm32_tpu_torch.device import full_fp32


@lru_cache(maxsize=32)
def kaiser_poly_filter(up: int, down: int) -> np.ndarray:
    """scipy resample_poly's FIR: firwin Kaiser(5.0) low-pass scaled by up.

    Args:
        up, down: Rate ratio, already reduced by gcd.

    Returns:
        float32 taps of length 2*10*max(up, down) + 1 (zero-phase center).
    """
    from scipy.signal import firwin

    max_rate = max(up, down)
    taps = firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, window=("kaiser", 5.0)) * up
    return taps.astype(np.float32)


def resample_output_len(n_in: int, sr_in: int, sr_out: int) -> int:
    """Output length of resample_poly: ceil(n_in * up / down)."""
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    return -(-n_in * up // down)


@lru_cache(maxsize=32)
def _polyphase_kernel(up: int, down: int) -> tuple[np.ndarray, int]:
    """([up, 1, width] float32 branch taps, left pad of the input)."""
    h = kaiser_poly_filter(up, down)
    n_taps = h.shape[0]
    half_len = (n_taps - 1) // 2
    n_branch = -(-n_taps // up)
    r = np.arange(up)
    c = (r * down + half_len) // up
    p = (r * down + half_len) % up
    # Branch r reads x[c_r + i*down - m], m < n_branch, at kernel position
    # pad + c_r - m with pad = n_branch - 1 - c_0 (>= 0 for every up, down).
    pad = n_branch - 1 - int(c[0])
    width = n_branch + int(c[-1] - c[0])
    kernel = np.zeros((up, 1, width), np.float32)
    for m in range(n_branch):
        idx = p + m * up
        ok = idx < n_taps
        kernel[r[ok], 0, pad + c[ok] - m] = h[idx[ok]]
    return kernel, pad


def resample_poly_device(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Batched resample [B, T] (or [T]) at sr_in -> [B, T_out] at sr_out, on
    x's device.

    Matches scipy.signal.resample_poly(x, up, down, axis=-1) with the
    default ('kaiser', 5.0) window and zero edge padding, to float32
    accuracy.
    """
    x = x.float()
    if sr_in == sr_out:
        return x
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    T = x.shape[-1]
    n_out = -(-T * up // down)
    kernel, pad = _polyphase_kernel(up, down)
    width = kernel.shape[-1]
    n_i = -(-n_out // up)  # outputs per branch
    pad_r = max(0, (n_i - 1) * down + width - pad - T)
    xp = F.pad(x[:, None, :], (pad, pad_r))
    w = torch.from_numpy(kernel).to(x.device)
    with full_fp32():
        out = F.conv1d(xp, w, stride=down)[:, :, :n_i]  # [B, up, n_i]
    y = out.transpose(1, 2).reshape(x.shape[0], n_i * up)[:, :n_out]
    return y[0] if squeeze else y


def resample_chunk_batch(wave: torch.Tensor, sr_in: int, cfg) -> torch.Tensor:
    """Resample a [B, T_src] chunk batch to exactly cfg.chunk_samples.

    Chunks arrive at the file's native rate with T_src = chunk_duration *
    sr_in samples; after resampling, rounding can leave the length one
    sample off cfg.chunk_samples, so the batch is padded or trimmed to the
    model's geometry.
    """
    y = resample_poly_device(wave, sr_in, cfg.sample_rate)
    want, have = cfg.chunk_samples, y.shape[-1]
    if have < want:
        y = F.pad(y, (0, want - have))
    elif have > want:
        y = y[:, :want]
    return y.contiguous()
