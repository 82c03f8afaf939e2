"""Optimizers and the cosine schedule (port of training/optimizer.py).

A small functional optimizer over named tensors, with the arithmetic of
the optax chain the JAX package builds:

    per-tensor clip (Keras clipnorm) -> adam | sgd (momentum 0.9) | adamw
    -> * -lr(count)

- the schedule is read at the count before the update, so the first
  update uses lr(0);
- adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root (eps_root 0),
  bias correction 1 - b^(count + 1);
- adamw: adam + weight_decay * p on every parameter (BN scale and bias
  included), then * -lr;
- sgd: trace t = g + 0.9 t (no dampening), update -lr t.

`update` returns the updates; the caller masks and applies them
(parallel/steps.py).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

VALID_OPTIMIZERS = ("adam", "sgd", "adamw")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9


def cosine_schedule(learning_rate: float, epochs: int,
                    steps_per_epoch: int) -> Callable[[int], float]:
    """Cosine decay over the whole run to 0 (Keras CosineDecay, alpha 0),
    evaluated in float32 as optax does."""
    decay_steps = np.float32(max(1, epochs * steps_per_epoch))
    lr = np.float32(learning_rate)

    def schedule(count: int) -> float:
        c = np.minimum(np.float32(count), decay_steps)
        cosine = np.float32(0.5) * (np.float32(1.0)
                                    + np.cos(np.float32(math.pi) * c / decay_steps))
        return float(lr * cosine)

    return schedule


def clip_by_per_variable_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """Keras `clipnorm`: each gradient tensor scaled to norm <= max_norm on
    its own (not the global norm)."""
    norms = torch.stack(torch._foreach_norm(grads))
    # A true division (a Python scalar over a tensor is a reciprocal
    # multiply in torch).
    factors = norms.new_tensor(max_norm) / torch.clamp_min(norms, max_norm)
    return torch._foreach_mul(grads, list(factors.unbind()))


class Optimizer:
    """clip -> adam | sgd | adamw -> * -lr(count), over dicts of tensors.

    learning_rate is a float or a schedule count -> float. State:
    {"count": int, "mu": {...}, "nu": {...}} for adam / adamw,
    {"count": int, "trace": {...}} for sgd.
    """

    def __init__(self, name: str, learning_rate: float | Callable[[int], float],
                 weight_decay: float = 0.0, gradient_clip_norm: float = 0.0):
        self.name = name.lower()
        if self.name not in VALID_OPTIMIZERS:
            raise ValueError(f"Invalid optimizer: {name!r}. Valid options: {VALID_OPTIMIZERS}")
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda _count, lr=float(learning_rate): lr))
        self.weight_decay = float(weight_decay)
        self.gradient_clip_norm = float(gradient_clip_norm or 0.0)

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        if self.name == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The updates for `grads` (to be added to the params); advances
        `state` in place. Multi-tensor (torch._foreach_*) operations, each
        the same elementwise float32 arithmetic as optax's."""
        names = list(grads)
        count = state["count"]
        step = float(-np.float32(self.schedule(count)))
        g = [grads[k] for k in names]
        if self.gradient_clip_norm > 0:
            g = clip_by_per_variable_norm(g, self.gradient_clip_norm)
        if self.name == "sgd":
            t = torch._foreach_add(g, torch._foreach_mul([state["trace"][k] for k in names],
                                                         SGD_MOMENTUM))
            state["trace"].update(zip(names, t))
            u = t
        else:
            n = count + 1
            # 0-d tensors: a division by a Python scalar is a reciprocal
            # multiply on CUDA.
            bc1 = g[0].new_tensor(float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(n)))
            bc2 = g[0].new_tensor(float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(n)))
            mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - ADAM_B1),
                                    torch._foreach_mul([state["mu"][k] for k in names], ADAM_B1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - ADAM_B2),
                                    torch._foreach_mul([state["nu"][k] for k in names], ADAM_B2))
            state["mu"].update(zip(names, mu))
            state["nu"].update(zip(names, nu))
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), ADAM_EPS)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
            if self.name == "adamw":
                u = torch._foreach_add(u, torch._foreach_mul([params[k] for k in names],
                                                             self.weight_decay))
        state["count"] = count + 1
        return dict(zip(names, torch._foreach_mul(u, step)))

def build_optimizer(
    name: str,
    learning_rate: float | Callable[[int], float],
    weight_decay: float = 0.0,
    gradient_clip_norm: float = 0.0,
) -> Optimizer:
    """adam | sgd (momentum 0.9) | adamw (+ weight decay), with the
    per-tensor clipnorm when gradient_clip_norm > 0."""
    return Optimizer(name, learning_rate, weight_decay, gradient_clip_norm)
