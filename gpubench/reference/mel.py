"""Slaney mel filterbank (librosa.filters.mel with htk=False,
norm="slaney"), written from the Auditory Toolbox formula in float64.

The harness seeds the hybrid frontend's mel mixer with it, and the frontend
roofline counts its nonzeros for the mel modes.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, 1e-20) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    m * _F_SP)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 150.0,
                   fmax: float | None = None) -> np.ndarray:
    """[n_fft // 2 + 1, n_mels] float32: mel = |STFT| @ fb."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    width = np.diff(edges)
    lower = (freqs[None, :] - edges[:-2, None]) / width[:-1, None]
    upper = (edges[2:, None] - freqs[None, :]) / width[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (edges[2:] - edges[:-2]))[:, None]
    return w.T.astype(np.float32)
