"""Batched augmentation on the device: multi-source Dirichlet mixup and
SpecAugment (port of data/augment.py).

Each augmentation comes in two parts: a draw (every random number, from an
explicit torch.Generator) and a deterministic apply. apply_mixup and
apply_spec_augment compose the two. Semantics, as in the JAX package:

- mixup: a fixed count round(B * probability) of rows (the first of a
  random permutation) are each mixed from 2 or 3 sources, the row itself
  and distinct partners, with Dirichlet(alpha) gains (normalised Gamma
  draws, + 1e-12 in the normaliser); their labels become the element-wise
  max (union) of the sources'; optional label smoothing (1-eps) y + eps/C.
- SpecAugment: 2 frequency and 2 time masks per sample zeroed on
  [B, F, T] or [B, F, T, 1] features; width ~ U[0, min(mask_max, dim)),
  start ~ U[0, max(1, dim - width)).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Marsaglia-Tsang candidates drawn per Gamma sample. One candidate is
# rejected with probability < 0.05 for shape >= 1 (the boosted shape
# alpha + 1 here), so all 16 are rejected with probability < 1e-20; such
# a sample keeps its last candidate.
_GAMMA_ROUNDS = 16


def gamma_draw(generator: torch.Generator, alpha: float, shape: tuple,
               device: torch.device) -> torch.Tensor:
    """float32 Gamma(alpha, 1) samples of `shape` from `generator`:
    Marsaglia-Tsang on shape alpha + 1, times U^(1/alpha) when alpha < 1.
    A fixed number of vectorised candidate rounds, so nothing synchronises
    with the host."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    n = (_GAMMA_ROUNDS, *shape)
    x = torch.randn(n, generator=generator, device=device)
    u = torch.rand(n, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-30)))
    # The first accepted round of each sample (the last one if none was).
    first = torch.where(ok.any(0), ok.float().argmax(0), _GAMMA_ROUNDS - 1)
    g = torch.gather(d * v, 0, first[None]).squeeze(0)
    if alpha < 1.0:
        g = g * torch.rand(shape, generator=generator, device=device) ** (1.0 / alpha)
    return g


@dataclass
class MixupDraw:
    """The random part of mixup for M mixed rows of S gain slots."""

    rows: torch.Tensor       # [M] int64, distinct rows of the batch
    o1: torch.Tensor         # [M] partner offsets in [1, B)
    o2: torch.Tensor         # [M] second offsets in [1, B), != o1
    n_sources: torch.Tensor  # [M] active sources, in [2, max_sources]
    gamma: torch.Tensor      # [M, S] float32 Gamma(alpha) draws


def mixup_count(batch_size: int, probability: float) -> int:
    return int(round(batch_size * probability))


def draw_mixup(generator: torch.Generator, batch_size: int, alpha: float = 0.2,
               probability: float = 0.25, max_sources: int = 3,
               device: str | torch.device = "cpu") -> MixupDraw:
    """Rows, distinct partners, source counts and Gamma gains of one batch."""
    if not 2 <= max_sources <= 3:
        raise ValueError(f"max_sources={max_sources}: supported range is [2, 3]")
    B, M = batch_size, mixup_count(batch_size, probability)
    g, dev = generator, torch.device(device)
    rows = torch.randperm(B, generator=g, device=dev)[:M]
    # Partners distinct from the row and from each other: o1 in [1, B), o2
    # in [1, B) minus o1 through a shifted draw over the other B - 2
    # offsets (max() guards B <= 2, where two distinct partners cannot
    # exist).
    o1 = torch.randint(1, max(B, 2), (M,), generator=g, device=dev)
    shift = torch.randint(1, max(B - 1, 2), (M,), generator=g, device=dev)
    o2 = 1 + (o1 - 1 + shift) % max(B - 1, 1)
    n_sources = torch.randint(2, max_sources + 1, (M,), generator=g, device=dev)
    gamma = gamma_draw(g, alpha, (M, max_sources), dev)
    return MixupDraw(rows, o1, o2, n_sources, gamma)


def smooth(labels: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    if label_smoothing > 0 and labels.shape[-1] > 1:
        C = labels.shape[-1]
        labels = (1.0 - label_smoothing) * labels + label_smoothing / C
    return labels


def mix(batch: torch.Tensor, labels: torch.Tensor, draw: MixupDraw,
        label_smoothing: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part of mixup: mix draw.rows from their sources."""
    B = batch.shape[0]
    M, S = draw.gamma.shape
    if M == 0:
        return batch, smooth(labels, label_smoothing)
    rows = draw.rows
    partners = torch.stack([(rows + draw.o1) % B, (rows + draw.o2) % B], dim=1)[:, : S - 1]
    sources = torch.cat([rows[:, None], partners], dim=1)  # [M, S]
    slot_active = torch.arange(S, device=batch.device)[None, :] < draw.n_sources[:, None]
    gamma = torch.where(slot_active, draw.gamma, 0.0)
    gains = gamma / (gamma.sum(dim=1, keepdim=True) + 1e-12)  # [M, S]
    src = batch[sources]  # [M, S, ...]
    mixed = (gains.reshape((M, S) + (1,) * (batch.ndim - 1)) * src).sum(dim=1)
    union = torch.where(slot_active[..., None], labels[sources], 0.0).amax(dim=1)
    batch = batch.index_copy(0, rows, mixed.to(batch.dtype))
    labels = labels.index_copy(0, rows, union)
    return batch, smooth(labels, label_smoothing)


def apply_mixup(generator: torch.Generator, batch: torch.Tensor, labels: torch.Tensor,
                alpha: float = 0.2, probability: float = 0.25,
                label_smoothing: float = 0.0,
                max_sources: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-source additive mixup over a batch [B, ...] with labels [B, C];
    draws nothing when alpha <= 0 or no row is mixed."""
    if not 2 <= max_sources <= 3:
        raise ValueError(f"max_sources={max_sources}: supported range is [2, 3]")
    if alpha <= 0 or mixup_count(batch.shape[0], probability) <= 0:
        return batch, smooth(labels, label_smoothing)
    draw = draw_mixup(generator, batch.shape[0], alpha, probability, max_sources,
                      batch.device)
    return mix(batch, labels, draw, label_smoothing)


def draw_masks(generator: torch.Generator, batch_size: int, dim: int, mask_max: int,
               n_masks: int, device: str | torch.device = "cpu"):
    """(widths, starts) [B, n_masks] int64 of one axis's masks."""
    dev = torch.device(device)
    width = torch.randint(0, max(1, min(mask_max, dim)), (batch_size, n_masks),
                          generator=generator, device=dev)
    high = torch.clamp_min(dim - width, 1)
    u = torch.rand((batch_size, n_masks), generator=generator, device=dev,
                   dtype=torch.float64)
    start = torch.minimum((u * high).floor().long(), high - 1)
    return width, start


def keep_mask(width: torch.Tensor, start: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, dim] bool: False inside any of the [B, n] masks."""
    pos = torch.arange(dim, device=width.device)[None, None, :]
    inside = (pos >= start[..., None]) & (pos < (start + width)[..., None])
    return ~inside.any(dim=1)


def mask_features(spec: torch.Tensor, freq: tuple, time: tuple) -> torch.Tensor:
    """The deterministic part of SpecAugment: zero the (widths, starts)
    masks of `freq` and `time` on [B, F, T] or [B, F, T, 1] features."""
    if spec.ndim == 4 and spec.shape[-1] != 1:
        raise ValueError(f"spec_augment expects [B, F, T] or [B, F, T, 1]; "
                         f"got trailing channel dim {spec.shape[-1]}")
    squeeze = spec.ndim == 4
    x = spec[..., 0] if squeeze else spec
    _, F, T = x.shape
    keep_f = keep_mask(*freq, F)
    keep_t = keep_mask(*time, T)
    x = x * keep_f[:, :, None] * keep_t[:, None, :]
    return x[..., None] if squeeze else x


def apply_spec_augment(generator: torch.Generator, spec: torch.Tensor,
                       freq_mask_max: int = 8, time_mask_max: int = 25,
                       num_freq_masks: int = 2, num_time_masks: int = 2) -> torch.Tensor:
    """Batched SpecAugment on [B, F, T] or [B, F, T, 1] features."""
    if spec.ndim == 4 and spec.shape[-1] != 1:
        raise ValueError(f"spec_augment expects [B, F, T] or [B, F, T, 1]; "
                         f"got trailing channel dim {spec.shape[-1]}")
    B, F, T = spec.shape[:3]
    freq = draw_masks(generator, B, F, freq_mask_max, num_freq_masks, spec.device)
    time = draw_masks(generator, B, T, time_mask_max, num_time_masks, spec.device)
    return mask_features(spec, freq, time)
