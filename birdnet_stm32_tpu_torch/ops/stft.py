"""Batched STFT magnitude as windowed-DFT matmuls (port of ops/stft.py).

Float32 only: the JAX package's bf16-I/O formulation waits for a later
slice. Matmuls run in full float32; on CUDA the callers hold TF32 off
(device.full_fp32), the equivalent of the reference's HIGHEST precision.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic (DFT-even) Hann window of length `n`.

    Matches `scipy.signal.get_window("hann", n, fftbins=True)`, which both
    librosa and the firmware table use.
    """
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(dtype)


def dft_bases(n_fft: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: frames @ Wc (+ j frames @ Ws) == rfft(frames*hann).

    Built in float64 and rounded once, exactly as the JAX package does, so
    both ports multiply by the same float32 constants.
    """
    win = hann_window(n_fft).astype(np.float64)
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return ((win[:, None] * np.cos(ang)).astype(dtype),
            (win[:, None] * np.sin(ang)).astype(dtype))


@functools.lru_cache(maxsize=16)
def dft_bases_tensor(n_fft: int, device: torch.device) -> torch.Tensor:
    """[n_fft, 2F] = [Wc | Ws] float32 on `device`, built once per geometry."""
    wc, ws = dft_bases(n_fft)
    return torch.from_numpy(np.concatenate([wc, ws], axis=1)).to(device)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                 center: bool = True) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_fft] overlapping frames (gather framing).

    center=True centres frame k at k*hop with zero padding (librosa);
    center=False starts frame k at k*hop (firmware), zero-padded past the end.
    """
    if center:
        pad = n_fft // 2
        y = F.pad(y, (pad, pad))
    needed = (n_frames - 1) * hop + n_fft
    if needed > y.shape[1]:
        y = F.pad(y, (0, needed - y.shape[1]))
    return y.unfold(1, n_fft, hop)[:, :n_frames]


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                   center: bool = True) -> torch.Tensor:
    """Batched |STFT| with a periodic Hann window, [B, T] -> [B, n_frames, F].

    When 2*hop >= n_fft >= hop, frame k spans rows k and k+1 of the
    [B, n_frames+1, hop] strided view, so the DFT is a window-2 product
    against the bases split at `hop` (the JAX package's conv formulation,
    ops/stft.py:144-191) and no frame tensor is built. Otherwise frames
    are gathered.
    """
    bases = dft_bases_tensor(n_fft, y.device)
    nbin = n_fft // 2 + 1
    if 2 * hop >= n_fft and hop <= n_fft:
        B = y.shape[0]
        if center:
            y = F.pad(y, (n_fft // 2, n_fft // 2))
        need = (n_frames + 1) * hop
        if need > y.shape[1]:
            y = F.pad(y, (0, need - y.shape[1]))
        z = y[:, :need].reshape(B, n_frames + 1, hop)
        out = (z[:, :-1] @ bases[:hop]
               + z[:, 1:, : n_fft - hop] @ bases[hop:])  # [B, n_frames, 2F]
    else:
        out = frame_signal(y, n_fft, hop, n_frames, center=center) @ bases
    re, im = out[..., :nbin], out[..., nbin:]
    return torch.sqrt(re * re + im * im)
