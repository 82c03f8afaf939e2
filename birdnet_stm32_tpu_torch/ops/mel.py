"""Slaney-style mel scale and triangular filterbank construction.

Numerically equivalent to `librosa.filters.mel(htk=False, norm="slaney")`,
which the reference uses everywhere (audio/spectrogram.py:117-130, the mel
mixer seed in models/frontend.py:257-276, and firmware/Src/audio_mel.c).
Implemented from the Slaney Auditory-Toolbox formula directly; librosa is
not a dependency of this framework.

Filterbank construction happens once at setup on the host (numpy); the
resulting [F, M] matrix is used on-device as a matmul after the STFT.

The PyTorch port keeps its own copy of birdnet_stm32_tpu/ops/mel.py (the
port imports nothing of the JAX package); the two must stay identical.
"""

from __future__ import annotations

import numpy as np

# Slaney mel-scale constants: linear below 1 kHz, logarithmic above.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: np.ndarray | float) -> np.ndarray:
    """Convert Hz to Slaney mel."""
    f = np.asarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-20) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    """Convert Slaney mel to Hz."""
    m = np.asarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs)
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """`n_mels` frequencies evenly spaced on the Slaney mel scale (in Hz)."""
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels)
    return mel_to_hz(mels)


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    """Center frequencies of rFFT bins."""
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 64,
    fmin: float = 150.0,
    fmax: float | None = None,
    norm: str = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, transposed for right-matmul.

    Args:
        sr: Sample rate (Hz).
        n_fft: FFT size.
        n_mels: Number of mel bands.
        fmin: Lowest band edge (Hz). Reference default is 150 Hz.
        fmax: Highest band edge (Hz), defaults to sr/2.
        norm: "slaney" (area normalization 2/(right-left)) or None.
        dtype: Output dtype.

    Returns:
        [n_fft//2 + 1, n_mels] filterbank matrix: mel = linear_mag @ fb.
    """
    if fmax is None:
        fmax = sr / 2.0
    freqs = fft_frequencies(sr, n_fft)  # [F]
    band_hz = mel_frequencies(n_mels + 2, fmin, fmax)  # [M+2] band edges

    # Rising/falling ramps per band, evaluated at every FFT bin.
    lower = (freqs[None, :] - band_hz[:-2, None]) / np.diff(band_hz)[:-1, None]
    upper = (band_hz[2:, None] - freqs[None, :]) / np.diff(band_hz)[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [M, F]

    if norm == "slaney":
        enorm = 2.0 / (band_hz[2 : n_mels + 2] - band_hz[:n_mels])
        weights = weights * enorm[:, None]
    return weights.T.astype(dtype)  # [F, M]
