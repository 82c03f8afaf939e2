"""Classification losses on logits: (weighted) BCE / CCE, focal,
distillation (port of training/losses.py).

Every function maps ([B, C] logits, [B, C] targets) -> a scalar tensor.
The loss is chosen as in the reference: binary focal when focal_gamma is
set (label smoothing ignored), BCE for multilabel, CCE otherwise.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F


def smooth_labels(labels: torch.Tensor, smoothing: float,
                  binary: bool = False) -> torch.Tensor:
    """Keras label smoothing: y (1 - eps) + eps / C for categorical CE,
    y (1 - eps) + eps / 2 for binary CE."""
    if smoothing <= 0:
        return labels
    if binary:
        return (1.0 - smoothing) * labels + smoothing / 2.0
    C = labels.shape[-1]
    return (1.0 - smoothing) * labels + smoothing / C


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid cross-entropy (optax.sigmoid_binary_cross_entropy)."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def categorical_crossentropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Softmax cross-entropy; with class_weights each example is weighted
    by the weight of its argmax true class (Keras semantics)."""
    labels = smooth_labels(labels, label_smoothing)
    per_example = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    if class_weights is not None:
        w = class_weights[labels.argmax(dim=-1)]
        return (per_example * w).sum() / (w.sum() + 1e-8)
    return per_example.mean()


def binary_crossentropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor | None = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean sigmoid BCE over [B, C], optionally weighted per class."""
    labels = smooth_labels(labels, label_smoothing, binary=True)
    per_class = _sigmoid_bce(logits, labels)
    if class_weights is not None:
        per_class = per_class * class_weights[None, :]
        return per_class.sum() / (labels.shape[0] * class_weights.sum() + 1e-8)
    return per_class.mean()


def binary_focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    gamma: float = 2.0,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Focal loss (Lin et al. 2017), mean over [B, C] of
    (1 - p_t)^gamma * BCE; gamma = 0 is BCE."""
    labels = smooth_labels(labels, label_smoothing)
    bce = _sigmoid_bce(logits, labels)
    p = torch.sigmoid(logits)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    return ((1.0 - p_t) ** gamma * bce).mean()


def distillation_loss(
    logits: torch.Tensor,
    hard_labels: torch.Tensor,
    soft_labels: torch.Tensor,
    alpha: float = 0.5,
    temperature: float = 3.0,
    multilabel: bool = False,
) -> torch.Tensor:
    """(1 - a) * hard loss + a * T^2 * KL(teacher_T || student_T), the
    teacher given as probabilities and both re-smoothed at temperature T
    in log space."""
    if multilabel:
        hard = binary_crossentropy(logits, hard_labels)
    else:
        hard = categorical_crossentropy(logits, hard_labels)
    T = temperature
    student_logp = torch.log_softmax(torch.log_softmax(logits, dim=-1) / T, dim=-1)
    teacher_p = torch.softmax(torch.log(soft_labels + 1e-7) / T, dim=-1)
    kl = (teacher_p * (torch.log(teacher_p + 1e-7) - student_logp)).sum(dim=-1)
    return (1.0 - alpha) * hard + alpha * (T * T) * kl.mean()


def make_loss_fn(
    multilabel: bool = False,
    focal_gamma: float | None = None,
    label_smoothing: float = 0.0,
    class_weights=None,
    device: str | torch.device = "cpu",
):
    """The training loss by the reference's rules: focal_gamma set ->
    binary focal (label smoothing ignored, as the reference never passes
    it); multilabel -> BCE (eps / 2 smoothing); otherwise CCE (eps / C).
    class_weights ([C]) go to `device`."""
    cw = None if class_weights is None else torch.as_tensor(
        class_weights, dtype=torch.float32, device=device)
    if focal_gamma is not None:
        return partial(binary_focal_loss, gamma=focal_gamma)
    if multilabel:
        return partial(binary_crossentropy, class_weights=cw, label_smoothing=label_smoothing)
    return partial(categorical_crossentropy, class_weights=cw, label_smoothing=label_smoothing)
