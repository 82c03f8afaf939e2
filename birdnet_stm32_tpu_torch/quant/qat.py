"""Quantization-aware training: the straight-through fake-quant train step
and the QAT fine-tune of a trained run (port of quant/qat.py).

The float32 parameters stay the optimizer's; inside the loss every
quantizable weight is fake-quantized with the straight-through estimator
(quant/fake_quant.py) and the model runs on those copies
(torch.func.functional_call). The model runs in train mode with every BN
on its running statistics (freeze_bn: no statistics update), so dropout
is on. BN scale and bias, and the frontend when it is not trainable, are
kept fixed: the keep-mask goes on the gradients and on the updates.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch
from torch.func import functional_call

from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.parallel import distributed
from birdnet_stm32_tpu_torch.parallel.steps import (
    TrainState,
    apply_gradients,
    conv_kernel_l2,
    freeze_mask,
    loss_and_grads,
)
from birdnet_stm32_tpu_torch.quant.fake_quant import (
    activation_fake_quant,
    fake_quantize_act,
    quantize_params,
)


def make_qat_train_step(
    model: torch.nn.Module,
    tx,
    loss_fn: Callable,
    num_bits: int = 8,
    per_channel: bool = True,
    kernel_l2: float = 1e-4,
    frontend_trainable: bool = True,
    act_fq: bool = False,
):
    """step(state, x, y) -> (state, {"loss", "grad_norm"}).

    act_fq=True also fake-quantizes what post-training quantization
    quantizes: the model input, every hookable ReLU6 output and the
    logits, each per-tensor (fake_quantize_act). The L2 term reads the
    float weights.
    """

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        model.train(freeze_bn=True)
        with full_fp32():
            q = quantize_params(state.params, num_bits=num_bits, per_channel=per_channel)
            if act_fq:
                with activation_fake_quant(num_bits):
                    logits = functional_call(model, q, (fake_quantize_act(x, num_bits),))
                logits = fake_quantize_act(logits, num_bits)
            else:
                logits = functional_call(model, q, (x,))
            loss = loss_fn(logits, y)
            if kernel_l2 > 0:
                loss = loss + conv_kernel_l2(state.params, kernel_l2)
            loss, grads = loss_and_grads(loss, state.params)
        keep = freeze_mask(state.params, frontend_trainable=frontend_trainable, freeze_bn=True)
        grad_norm = apply_gradients(state, tx, grads, keep)
        distributed.all_reduce_mean_([loss])
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def run_qat(
    run_dir,
    train_batches,
    val_batches,
    out_dir=None,
    epochs: int = 5,
    steps_per_epoch: int = 100,
    learning_rate: float = 1e-5,
    multilabel: bool = False,
    num_classes: int | None = None,
    seed: int = 0,
    batcher=None,
    monitor: str = "val_loss",
    act_fq: bool = False,
    device: str | torch.device = "cuda",
):
    """QAT fine-tune of the best weights of `run_dir` into `<run_dir>_qat`
    (or out_dir), through training/trainer.py::train_model with qat=True.

    num_classes: the dataset's class count, checked against the run's.
    batcher: the device transform of the training feed (the CLI passes an
    augmentation-free dequantizing one); None computes the features only.
    Returns (best state_dict, history).
    """
    from birdnet_stm32_tpu_torch.training.checkpoint import load_checkpoint
    from birdnet_stm32_tpu_torch.training.trainer import train_model
    from birdnet_stm32_tpu_torch.utils.logging import info

    run_dir = Path(run_dir)
    model, _, cfg = load_checkpoint(run_dir, class_activation="none", device=device)
    if num_classes is not None and num_classes != cfg.num_classes:
        raise ValueError(
            f"QAT dataset has {num_classes} classes but the checkpoint was "
            f"trained with {cfg.num_classes}; QAT must use the same class set.")
    out_dir = Path(out_dir) if out_dir else run_dir.with_name(run_dir.name + "_qat")
    info("qat", f"fine-tuning {run_dir} -> {out_dir} (lr={learning_rate}, "
                f"{epochs}x{steps_per_epoch} steps, BN frozen)")
    return train_model(
        model, cfg, train_batches, val_batches, out_dir,
        epochs=epochs, steps_per_epoch=steps_per_epoch,
        learning_rate=learning_rate, multilabel=multilabel, seed=seed,
        qat=True, qat_act=act_fq, batcher=batcher, monitor=monitor, device=device)
