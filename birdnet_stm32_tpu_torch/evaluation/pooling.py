"""Chunk-to-file score pooling: average, max, log-mean-exp (port of
evaluation/pooling.py).

pool_scores and lme_pooling pool one file's [N_chunks, C] scores in numpy,
as the JAX package does on the host. segment_pool pools a whole
evaluation's chunk scores by file id on a tensor's device: index_add_ for
the sums, scatter_reduce's "amax" for max and LME; a file with no chunk
gives zeros, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

POOLING_METHODS = ("avg", "mean", "average", "max", "lme", "log_mean_exp", "log_mean_exponential")

_AVG_NAMES = frozenset({"avg", "mean", "average"})
_LME_NAMES = frozenset({"lme", "log_mean_exp", "log_mean_exponential"})


def lme_pooling(scores: np.ndarray, beta: float = 10.0) -> np.ndarray:
    """Temperature-weighted soft pooling over the chunk axis:
    log(mean(exp(beta * s))) / beta in shifted form (the per-class max
    subtracted before exp), with the reference's epsilon inside the log.
    beta -> 0 gives the mean, beta -> inf the max."""
    if scores.size == 0:
        return scores
    z = beta * scores
    shift = z.max(axis=0, keepdims=True)
    soft_mean = np.exp(z - shift).mean(axis=0, keepdims=True)
    return ((shift + np.log(soft_mean + 1e-12)) / beta).ravel()


def pool_scores(chunk_scores: np.ndarray, method: str = "average", beta: float = 10.0) -> np.ndarray:
    """[N_chunks, C] -> [C] file-level scores; no chunk gives zeros."""
    if chunk_scores.ndim != 2:
        raise ValueError("chunk_scores must be [N_chunks, C]")
    if len(chunk_scores) == 0:
        return np.zeros(chunk_scores.shape[1], np.float32)
    m = method.lower()
    if m in _AVG_NAMES:
        return chunk_scores.mean(axis=0)
    if m == "max":
        return chunk_scores.max(axis=0)
    if m in _LME_NAMES:
        return lme_pooling(chunk_scores, beta=beta)
    raise ValueError(f"Unsupported pooling method: {method}")


def _segment_max(x: torch.Tensor, ids: torch.Tensor, num_files: int) -> torch.Tensor:
    """Per-file max of [N, C]; files with no row get -inf (as
    jax.ops.segment_max)."""
    out = torch.full((num_files, x.shape[1]), -torch.inf, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, ids[:, None].expand_as(x), x, "amax", include_self=False)


def segment_pool(chunk_scores: torch.Tensor, file_ids: torch.Tensor, num_files: int,
                 method: str = "average", beta: float = 10.0) -> torch.Tensor:
    """Pool [N, C] chunk scores into [num_files, C] by file id, on their
    device."""
    method = method.lower()
    ids = file_ids.long()
    raw_counts = torch.zeros(num_files, 1, dtype=chunk_scores.dtype, device=chunk_scores.device)
    raw_counts.index_add_(0, ids, torch.ones_like(chunk_scores[:, :1]))
    empty = raw_counts <= 0
    counts = torch.clamp_min(raw_counts, 1.0)
    zero = torch.zeros((), dtype=chunk_scores.dtype, device=chunk_scores.device)
    if method in _AVG_NAMES:
        sums = torch.zeros(num_files, chunk_scores.shape[1], dtype=chunk_scores.dtype,
                           device=chunk_scores.device).index_add_(0, ids, chunk_scores)
        return sums / counts
    if method == "max":
        return torch.where(empty, zero, _segment_max(chunk_scores, ids, num_files))
    if method in _LME_NAMES:
        z = beta * chunk_scores
        m = torch.where(empty, zero, _segment_max(z, ids, num_files))
        shifted = torch.exp(z - m[ids])
        mean = torch.zeros_like(m).index_add_(0, ids, shifted) / counts
        return torch.where(empty, zero, (m + torch.log(mean + 1e-12)) / beta)
    raise ValueError(f"Unsupported pooling method: {method}")
