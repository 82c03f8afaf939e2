"""Batched STFT magnitude as windowed-DFT matmuls (port of ops/stft.py).

Matmuls run in full float32; on CUDA the callers hold TF32 off
(device.full_fp32), the equivalent of the reference's HIGHEST precision.
A GPU has no multi-pass trade like the TPU's MXU, so the JAX package's
'high' and 'default' precisions compute the same full float32 here, with
one exception that is a change of formulation, not of precision: with a
bfloat16 out_dtype they select the bf16-I/O formulation of the JAX
package (frames rounded to bf16 once, the bases split into two bf16 limbs
over a doubled contraction, float32 accumulation, one rounding to bf16).
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


@functools.lru_cache(maxsize=16)
def dft_limbs_tensor(n_fft: int, device: torch.device) -> torch.Tensor:
    """[2 * n_fft, 2F] float32 on `device`: the bf16 hi limb of [Wc | Ws]
    stacked over its bf16 lo limb (the bases minus the hi limb, rounded to
    bf16), each limb exactly representable in bf16."""
    bases = torch.from_numpy(np.concatenate(dft_bases(n_fft), axis=1))
    hi = bases.to(torch.bfloat16)
    lo = (bases - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=0).float().to(device)


def _bf16_io_magnitude(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The JAX package's bf16-I/O DFT (ops/stft.py:161-184 and 193-208):
    frames rounded to bf16 once, times both bf16 limbs of the bases over a
    doubled contraction, accumulated in float32 (each product of two bf16
    values is exact in float32) and rounded to bf16 once; the magnitude
    in float32 from those bf16 values, stored as bf16."""
    nbin = n_fft // 2 + 1
    f_hi = frames.to(torch.bfloat16).float()
    out = (torch.cat([f_hi, f_hi], dim=-1) @ dft_limbs_tensor(n_fft, frames.device))
    out = out.to(torch.bfloat16).float()
    re, im = out[..., :nbin], out[..., nbin:]
    return torch.sqrt(re * re + im * im).to(torch.bfloat16)


PRECISIONS = ("highest", "high", "default")


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                   center: bool = True, precision: str = "highest",
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Batched |STFT| with a periodic Hann window, [B, T] -> [B, n_frames, F].

    When 2*hop >= n_fft >= hop, frame k spans rows k and k+1 of the
    [B, n_frames+1, hop] strided view, so the DFT is a window-2 product
    against the bases split at `hop` (the JAX package's conv formulation,
    ops/stft.py:144-191) and no frame tensor is built. Otherwise frames
    are gathered.

    out_dtype None keeps y's dtype. torch.bfloat16 with precision 'high'
    or 'default' selects the bf16-I/O formulation (module docstring); any
    other combination computes in float32 and casts the magnitude.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"Invalid precision: {precision!r}")
    out_dtype = out_dtype or y.dtype
    if out_dtype == torch.bfloat16 and precision in ("high", "default"):
        if 2 * hop >= n_fft and hop <= n_fft:
            # Frame k is row k of the strided view ++ the head of row k+1.
            z = _strided_rows(y, n_fft, hop, n_frames, center)
            frames = torch.cat([z[:, :-1], z[:, 1:, : n_fft - hop]], dim=-1)
        else:
            frames = frame_signal(y, n_fft, hop, n_frames, center=center)
        return _bf16_io_magnitude(frames, n_fft)
    return _magnitude_f32(y, n_fft, hop, n_frames, center).to(out_dtype)


def _strided_rows(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                  center: bool) -> torch.Tensor:
    """[B, T] -> the [B, n_frames + 1, hop] view of the centre-padded input."""
    B = y.shape[0]
    if center:
        y = F.pad(y, (n_fft // 2, n_fft // 2))
    need = (n_frames + 1) * hop
    if need > y.shape[1]:
        y = F.pad(y, (0, need - y.shape[1]))
    return y[:, :need].reshape(B, n_frames + 1, hop)


def _magnitude_f32(y: torch.Tensor, n_fft: int, hop: int, n_frames: int,
                   center: bool) -> torch.Tensor:
    bases = dft_bases_tensor(n_fft, y.device)
    nbin = n_fft // 2 + 1
    if 2 * hop >= n_fft and hop <= n_fft:
        z = _strided_rows(y, n_fft, hop, n_frames, center)
        out = (z[:, :-1] @ bases[:hop]
               + z[:, 1:, : n_fft - hop] @ bases[hop:])  # [B, n_frames, 2F]
    else:
        out = frame_signal(y, n_fft, hop, n_frames, center=center) @ bases
    re, im = out[..., :nbin], out[..., nbin:]
    return torch.sqrt(re * re + im * im)


def stft_magnitude_host(
    y: np.ndarray,
    n_fft: int,
    hop: int,
    center: bool = True,
    n_frames: int | None = None,
) -> np.ndarray:
    """Numpy twin of stft_magnitude for host-side golden tests: [F, W]
    (frequency-major, like librosa) for one 1-D waveform, by np.fft.rfft in
    float64 of the Hann-windowed frames, rounded to float32 once."""
    if n_frames is None:
        n_frames = 1 + len(y) // hop if center else int(np.ceil(len(y) / hop))
    if center:
        pad = n_fft // 2
        y = np.pad(y, (pad, pad))
    needed = (n_frames - 1) * hop + n_fft
    if needed > len(y):
        y = np.pad(y, (0, needed - len(y)))
    win = hann_window(n_fft).astype(np.float64)
    frames = np.stack([y[k * hop : k * hop + n_fft] for k in range(n_frames)])
    return np.abs(np.fft.rfft(frames * win, axis=-1)).T.astype(np.float32)
