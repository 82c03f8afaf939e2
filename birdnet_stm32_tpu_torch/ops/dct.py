"""Orthonormal DCT-II as a matrix product (port of ops/dct.py).

Used by the mfcc frontend (librosa.feature.mfcc with norm="ortho"). The
basis is built in float64 with numpy and rounded once, as the JAX package
builds it, so both packages multiply by the same float32 constants.
"""

from __future__ import annotations

import numpy as np
import torch


def dct_matrix(n_in: int, n_out: int, dtype=np.float32) -> np.ndarray:
    """[n_in, n_out] orthonormal DCT-II basis: coeffs = x @ dct_matrix.

    y[k] = s_k * sum_n x[n] * 2*cos(pi*(2n+1)*k / (2N)), with
    s_0 = sqrt(1/(4N)) and s_k = sqrt(1/(2N)) for k > 0, identical to
    `scipy.fft.dct(x, type=2, norm="ortho")`.
    """
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    basis = 2.0 * np.cos(np.pi * (2.0 * n[:, None] + 1.0) * k[None, :] / (2.0 * n_in))
    scale = np.full((n_out,), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0] = np.sqrt(1.0 / (4.0 * n_in))
    return (basis * scale[None, :]).astype(dtype)


def dct2_ortho(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """[..., n_in] -> [..., n_out] orthonormal DCT-II along the last axis."""
    mat = torch.from_numpy(dct_matrix(x.shape[-1], n_out)).to(device=x.device, dtype=x.dtype)
    return x @ mat
