"""Knowledge distillation: training against a teacher's soft labels (port
of training/distillation.py).

The combined target is [B, 2C] = concat(hard labels, teacher
probabilities), so the training loop carries it like any label tensor; the
loss splits it and mixes the hard loss with the T^2-scaled KL divergence
to the temperature-smoothed teacher (training/losses.py::distillation_loss).
The JAX package has no CLI option for it; neither has the port.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
from birdnet_stm32_tpu_torch.training.losses import distillation_loss


def make_distillation_loss(num_classes: int, alpha: float = 0.5,
                           temperature: float = 3.0,
                           multilabel: bool = False) -> Callable:
    """(logits, [B, 2C] hard ++ teacher targets) -> scalar loss."""
    def loss_fn(logits: torch.Tensor, y_cat: torch.Tensor) -> torch.Tensor:
        return distillation_loss(logits, y_cat[:, :num_classes], y_cat[:, num_classes:],
                                 alpha=alpha, temperature=temperature, multilabel=multilabel)

    return loss_fn


def make_teacher_batcher(base_batcher: Callable, teacher_fn: Callable) -> Callable:
    """Wrap a device batcher (generator, wave, labels) -> (inputs, labels
    [B, C]) so that the labels become [B, 2C] with the teacher's
    probabilities on the batcher's inputs (no gradient)."""
    def batcher(generator, wave, labels):
        x, y = base_batcher(generator, wave, labels)
        with torch.no_grad():
            soft = teacher_fn(x)
        return x, torch.cat([y, soft.to(y.dtype)], dim=-1)

    return batcher


def run_distillation(
    student_model: torch.nn.Module,
    cfg,
    teacher_fn: Callable,
    train_batches,
    val_batches,
    run_dir,
    alpha: float = 0.5,
    temperature: float = 3.0,
    multilabel: bool = False,
    base_batcher: Callable | None = None,
    device: str | torch.device = "cuda",
    **train_kwargs,
):
    """Train `student_model` (class_activation 'none') against `teacher_fn`
    (model inputs -> teacher probabilities [B, C], on the device) with the
    distillation loss, through training/trainer.py::train_model.

    base_batcher: the device transform of the training waves (default: the
    frontend only). Validation feeds the features (the frontend runs once
    per batch) with the teacher-augmented targets, under the same loss.
    Returns (best state_dict, history).
    """
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.training.trainer import train_model

    dev = resolve_device(device)
    if base_batcher is None:
        def base_batcher(_generator, wave, labels):
            return frontend_input(wave, cfg), labels

    def val_with_teacher():
        for wave, labels in val_batches():
            x = frontend_input(torch.as_tensor(wave).to(dev), cfg)
            with torch.no_grad():
                soft = teacher_fn(x).float().cpu().numpy()
            yield x, np.concatenate([np.asarray(labels, np.float32), soft], axis=-1)

    return train_model(
        student_model, cfg, train_batches, val_with_teacher, run_dir,
        multilabel=multilabel, batcher=make_teacher_batcher(base_batcher, teacher_fn),
        loss_fn_override=make_distillation_loss(cfg.num_classes, alpha, temperature,
                                                multilabel),
        device=dev, **train_kwargs)
