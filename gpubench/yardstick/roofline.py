"""Least time of the frontend kernels at given shapes (a frozen copy of
chip_smoke.py::bound, with the geometry passed in).

Bytes: each waveform sample read once (4 bytes) and each feature written
once (4 bytes, or 1 for an int8 entry code), at the HBM peak. Operations:
the real-input FFT (~2.5 n log2 n), the window, |.| (2 multiplies, an add
and a square root per bin), the mel bank's nonzeros (a multiply-add each),
mfcc's DCT, and the epilogue per element (the quantize too for int8
codes), at the float32 peak outside the tensor cores. The larger of the two
times bounds.
"""

from __future__ import annotations

import math

import numpy as np

from gpubench.reference.mel import mel_filterbank
from gpubench.yardstick.peaks import HBM_BYTES_PER_S, OPS_PER_S

# Operations per output element of the int8-entry epilogue: multiply, |.|,
# + 0.5, floor, sign, + zp, clamp.
QUANT_OPS = 7
# Operations per post-mel element beyond min, max, subtract and divide (4).
SCALE_OPS = {"none": 0, "pwl": 16, "db": 8, "pcen": 14, "log_mel": 1, "mfcc": 6}


def frontend_bound(mode: str, mag: str, *, rows: int, samples: int, n_fft: int,
                   sample_rate: int, mel_bins: int, n_mfcc: int, spec_width: int,
                   int8: bool = False) -> tuple[float, str]:
    """(least milliseconds for one launch over `rows` chunks, "operations"
    or "bytes", whichever bounds)."""
    hop = max(1, samples // spec_width)
    n_frames = 1 + samples // hop if mode == "mfcc" else spec_width
    bins = {"linear": n_fft // 2 + 1, "mfcc": n_mfcc}.get(mode, mel_bins)
    n_bins = n_fft // 2 + 1
    per_frame = 2.5 * n_fft * math.log2(n_fft) + n_fft + 4 * n_bins
    if mode == "linear":
        channels = n_bins
    else:
        channels = mel_bins
        per_frame += 2 * np.count_nonzero(mel_filterbank(sample_rate, n_fft, mel_bins,
                                                         fmin=150.0,
                                                         fmax=float(sample_rate // 2)))
    ops = n_frames * (per_frame + channels * (4 + SCALE_OPS[mode if mode in SCALE_OPS else mag]))
    if mode == "mfcc":
        ops += spec_width * n_mfcc * (2 * mel_bins + 4)
    if int8:
        ops += spec_width * bins * QUANT_OPS
    ops *= rows
    n_bytes = 4.0 * rows * samples + (1.0 if int8 else 4.0) * rows * bins * spec_width
    t_ops = ops / OPS_PER_S["float32"] * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
