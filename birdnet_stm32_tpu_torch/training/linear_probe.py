"""Linear probing: train only a fresh classifier head on a new class set
(port of training/linear_probe.py).

The probe keeps a trained model's backbone (every weight and BN statistic
but the `pred` head), draws a new head for the new classes and trains it
alone: the backbone gets no update (it stays bit-identical), BN runs on its
running statistics, dropout is on. The best validation epoch is saved as a
run directory.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.parallel.steps import TrainState, loss_and_grads
from birdnet_stm32_tpu_torch.training import checkpoint as ckpt
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer, cosine_schedule
from birdnet_stm32_tpu_torch.utils.logging import info, warn

HEAD = "pred"
# jax.nn.initializers.lecun_normal draws a normal truncated to +-2 standard
# deviations, rescaled by this factor to keep the variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def make_probe(state_dict: dict[str, torch.Tensor], cfg: ModelConfig, new_classes: list[str],
               generator: torch.Generator | None = None,
               device: str | torch.device = "cuda"):
    """(model, new_cfg): a DSCNN (class_activation 'none', on `device`) with
    the backbone of `state_dict` and a fresh head [emb -> len(new_classes)]:
    LeCun-normal weights drawn on the CPU from `generator` (default seed
    0), zero bias. Head column i is new_classes[i]."""
    new_cfg = dataclasses.replace(cfg, num_classes=len(new_classes),
                                  class_names=list(new_classes))
    model = build_dscnn(new_cfg, class_activation="none", device=device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    emb = state_dict[f"{HEAD}.weight"].shape[1]
    w = torch.empty(len(new_classes), emb)
    std = math.sqrt(1.0 / emb) / _TRUNC_STD
    torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=g)
    sd = {k: v for k, v in state_dict.items() if not k.startswith(f"{HEAD}.")}
    sd[f"{HEAD}.weight"] = w
    sd[f"{HEAD}.bias"] = torch.zeros(len(new_classes))
    model.load_state_dict(sd, strict=True)
    return model, new_cfg


def head_only_mask(params: dict) -> dict[str, bool]:
    """True for the head's parameters, False for the backbone's."""
    return {k: k.split(".")[0] == HEAD for k in params}


class _HeadOnly:
    """`tx` over the head's parameters only; every backbone update is zero
    (optax.multi_transform with set_to_zero for the backbone)."""

    def __init__(self, tx, params: dict):
        self.tx = tx
        self.keep = head_only_mask(params)

    def _head(self, tree: dict) -> dict:
        return {k: v for k, v in tree.items() if self.keep[k]}

    def init(self, params: dict) -> dict:
        return self.tx.init(self._head(params))

    def update(self, grads: dict, state: dict, params: dict) -> dict:
        """Updates for the keys of `grads`: tx's for the head, zeros else."""
        updates = self.tx.update(self._head(grads), state, self._head(params))
        return {k: updates[k] if self.keep[k] else torch.zeros_like(g)
                for k, g in grads.items()}


def head_only_optimizer(tx, params: dict) -> _HeadOnly:
    """`tx` over the head's parameters only (backbone updates zero)."""
    return _HeadOnly(tx, params)


def run_linear_probe(
    state_dict: dict[str, torch.Tensor],
    cfg: ModelConfig,
    new_classes: list[str],
    train_batches,
    val_batches,
    run_dir: str | Path,
    epochs: int = 10,
    steps_per_epoch: int = 50,
    learning_rate: float = 1e-3,
    multilabel: bool = False,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[dict, list[dict]]:
    """Train a fresh head on the backbone of `state_dict` (a trained run's
    weights) with adam and a cosine schedule.

    train_batches: iterator of (model inputs, labels [B, len(new_classes)]);
    val_batches: zero-argument callable of a finite iterable of the same.
    The best validation loss (unweighted mean over batches) is saved to
    `run_dir`; if no validation loss is ever finite, the final state is.
    Returns (best state_dict, history).
    """
    model, probe_cfg = make_probe(state_dict, cfg, new_classes,
                                  torch.Generator().manual_seed(seed), device=device)
    dev = next(model.parameters()).device
    info("probe", f"training head for {len(new_classes)} classes, backbone frozen")

    schedule = cosine_schedule(learning_rate, epochs, steps_per_epoch)
    params = dict(model.named_parameters())
    tx = head_only_optimizer(build_optimizer("adam", schedule), params)
    state = TrainState(step=0, params=params, buffers=dict(model.named_buffers()),
                       opt_state=tx.init(params))
    loss_fn = make_loss_fn(multilabel=multilabel, device=dev)
    head = [k for k in state.params if tx.keep[k]]

    def step(x, y):
        model.train(freeze_bn=True)
        with full_fp32():
            loss, grads = loss_and_grads(loss_fn(model(x), y),
                                         {k: state.params[k] for k in head})
        with torch.no_grad():
            # The backbone's gradients and updates are zero: only the head's
            # are computed, and only the head is added to (adding a zero
            # update would turn a -0.0 weight into +0.0).
            updates = tx.update(grads, state.opt_state, state.params)
            torch._foreach_add_([state.params[k] for k in head], [updates[k] for k in head])
        state.step += 1
        return loss

    @torch.no_grad()
    def eval_loss(x, y) -> float:
        model.eval()
        with full_fp32():
            return float(loss_fn(model(x), y))

    def to_dev(a):
        return torch.as_tensor(a).to(dev)

    history = []
    best_val, best_vars = float("inf"), state.variables()
    run_dir = Path(run_dir)
    for epoch in range(epochs):
        losses = [step(*map(to_dev, next(train_batches))) for _ in range(steps_per_epoch)]
        train_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        vals = [eval_loss(to_dev(x), to_dev(y)) for x, y in val_batches()]
        val_loss = float(np.mean(vals)) if vals else float("nan")
        history.append({"loss": train_loss, "val_loss": val_loss})
        info("probe", f"epoch {epoch + 1}/{epochs} loss={train_loss:.4f} val={val_loss:.4f}")
        if val_loss < best_val:
            best_val = val_loss
            best_vars = state.variables()
            ckpt.save_checkpoint(run_dir, best_vars, probe_cfg)
    if not np.isfinite(best_val):
        warn("probe", "no finite validation loss; saving the FINAL epoch "
                      "state instead of a best-val checkpoint")
        best_vars = state.variables()
        ckpt.save_checkpoint(run_dir, best_vars, probe_cfg)
    return best_vars, history


def assert_backbone_frozen(before: dict[str, torch.Tensor], after: dict[str, torch.Tensor]) -> None:
    """Every tensor but the head's is bit-identical in `after` (state_dicts)."""
    for k, a in before.items():
        if k.split(".")[0] == HEAD:
            continue
        b = after[k]
        same = a.shape == b.shape and (
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            if a.dtype == torch.float32 else torch.equal(a, b))
        assert same, f"backbone tensor {k} moved during probe"
