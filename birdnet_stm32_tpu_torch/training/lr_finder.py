"""Learning-rate finder: a geometric sweep with a steepest-descent
suggestion (port of training/lr_finder.py).

The sweep trains a copy of the model with plain SGD, one learning rate per
step from min_lr to max_lr, in train mode (BN batch statistics and their
running update, dropout), records the loss and its bias-corrected EMA, and
stops at the first non-finite loss or once the smoothed loss passes
explosion_factor times its best. The caller's model is left as it was.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.parallel.steps import loss_and_grads


def run_lr_finder(
    model: torch.nn.Module,
    batches,
    loss_fn,
    min_lr: float = 1e-7,
    max_lr: float = 1.0,
    num_steps: int = 100,
    smoothing: float = 0.98,
    explosion_factor: float = 4.0,
) -> dict:
    """Sweep the learning rate over a copy of `model` (a DSCNN with
    class_activation='none').

    batches: iterator of (model inputs, labels), numpy or tensors; they go
    to the model's device.

    Returns {"lrs", "losses", "smoothed", "suggested_lr"}.
    """
    gamma = (max_lr / min_lr) ** (1.0 / max(1, num_steps - 1))
    sweep = copy.deepcopy(model)
    dev = next(sweep.parameters()).device
    params = dict(sweep.named_parameters())

    lrs, losses, smoothed = [], [], []
    avg = 0.0
    best = float("inf")
    for i in range(num_steps):
        lr = min_lr * gamma**i
        x, y = next(batches)
        sweep.train()
        with full_fp32():
            loss = loss_fn(sweep(torch.as_tensor(x).to(dev)), torch.as_tensor(y).to(dev))
            loss, grads = loss_and_grads(loss, params)
        with torch.no_grad():
            # optax sgd: u = g * float32(-lr), then p + u.
            step = float(-np.float32(lr))
            torch._foreach_add_(list(params.values()),
                                torch._foreach_mul(list(grads.values()), step))
        loss = float(loss)
        if not np.isfinite(loss):
            break
        avg = smoothing * avg + (1 - smoothing) * loss
        corrected = avg / (1 - smoothing ** (i + 1))
        lrs.append(lr)
        losses.append(loss)
        smoothed.append(corrected)
        best = min(best, corrected)
        if i > 10 and corrected > explosion_factor * best:
            break

    return {"lrs": lrs, "losses": losses, "smoothed": smoothed,
            "suggested_lr": suggest_lr(lrs, smoothed)}


def suggest_lr(lrs: list[float], smoothed: list[float]) -> float:
    """The learning rate at the steepest descent of the smoothed curve
    (the middle one of fewer than 5; 1e-3 with none)."""
    if len(lrs) < 5:
        return lrs[len(lrs) // 2] if lrs else 1e-3
    d = np.gradient(np.asarray(smoothed), np.log10(np.asarray(lrs)))
    return float(lrs[int(np.argmin(d))])
