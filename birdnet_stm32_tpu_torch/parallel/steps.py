"""The train and eval steps (port of parallel/steps.py).

The train step: train-mode forward (BN batch statistics, dropout), loss
on the logits + the L2 of the block convolutions' kernels, gradients,
the freeze mask on the gradients, the optimizer (training/optimizer.py),
the freeze mask on the updates, p + u, then the NonNeg clamp of the
hybrid mel mixer. Convolutions and matmuls run in full float32
(device.full_fp32: no TF32).

Mixed precision (compute_dtype=torch.bfloat16) is the JAX step's in-graph
cast: the forward and backward run on bf16 copies of the parameters
(torch.func.functional_call, so the gradients reach the float32 masters
through the casts) and on bf16 inputs; the BN running statistics stay the
model's float32 buffers, the logits are cast to float32 before the loss,
and the L2 term, the optimizer and the masters stay float32. Layers
compute in the result dtype of their input and parameters
(models/blocks.py::promote), as Flax's do.

Data-parallel (parallel/distributed.py): under a process group each rank
steps on its local rows, and the step is the global batch's, as the JAX
step under GSPMD: the gradients are all-reduced to their mean before the
optimizer and its global-norm clip, the reported loss is the ranks' mean,
and train-mode BN takes its statistics over every rank's rows. Without a
process group nothing changes.

make_infer_fn is the eval-mode forward over one device or a local mesh
(parallel/mesh.py): a replica on each distinct device, the batch in row
blocks, the scores gathered in row order. Serving
(models/runners.py::TorchRunner) runs infer_block on each row block of
its own replicas; its calls open spans (utils/tracing.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.func import functional_call

from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.parallel import distributed
from birdnet_stm32_tpu_torch.parallel.mesh import gather, local_mesh, replicated, shard_batch

MEL_MIXER = "audio_frontend.mel_mixer"
# The kernels the reference regularizes: the stage blocks' depthwise,
# pointwise, expand and project convolutions. Not the stem, emb, SE dense
# layers ('stageN_seM_expand', 'stageN_irM_se_expand'), attention score,
# frontend or head.
_BLOCK_KERNEL = re.compile(r"stage\d+_(ir|ds)\d+_(dw|pw|expand|project)$")


@dataclass
class TrainState:
    """Step count, the model's own parameters and buffers (the steps update
    them in place), and the optimizer state."""

    step: int
    params: dict[str, torch.nn.Parameter]
    buffers: dict[str, torch.Tensor]
    opt_state: dict

    @classmethod
    def create(cls, model: torch.nn.Module, tx) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, params=params, buffers=dict(model.named_buffers()),
                   opt_state=tx.init(params))

    def variables(self) -> dict[str, torch.Tensor]:
        """A state_dict of the parameters and buffers (copies)."""
        return {k: v.detach().clone() for k, v in {**self.params, **self.buffers}.items()}


def _project_nonneg_mel_mixer(params: dict[str, torch.Tensor]) -> None:
    """Keras NonNeg constraint of the hybrid mel mixer: clamp after each
    update."""
    if MEL_MIXER in params:
        params[MEL_MIXER].data.clamp_(min=0.0)


def conv_kernel_l2(params: dict[str, torch.Tensor], coeff: float) -> torch.Tensor:
    """coeff * sum ||K||^2 over the block convolutions' kernels."""
    total = 0.0
    for name, p in params.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and _BLOCK_KERNEL.fullmatch(module):
            total = total + torch.sum(p * p)
    return coeff * total


def freeze_mask(params: dict[str, Any], frontend_trainable: bool = True,
                freeze_bn: bool = False) -> dict[str, bool]:
    """Keep-mask over the parameters: frontend_trainable=False drops the
    frontend's, freeze_bn=True every BN's scale and bias. Apply it to the
    gradients and to the updates (decoupled weight decay moves params
    otherwise)."""
    def keep(name: str) -> bool:
        parts = name.split(".")
        if not frontend_trainable and parts[0] == "audio_frontend":
            return False
        if freeze_bn and any(p.endswith("_bn") or p == "bn" for p in parts[:-1]):
            return False
        return True

    return {k: keep(k) for k in params}


def _masked(tree: dict[str, torch.Tensor], keep: dict[str, bool]) -> dict[str, torch.Tensor]:
    return {k: v * float(keep[k]) for k, v in tree.items()}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tree.values()))))


def loss_and_grads(loss: torch.Tensor, params: dict[str, torch.Tensor]):
    """(detached loss, {name: gradient}) with zeros for parameters the
    loss does not reach."""
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None else g
                           for k, g in zip(names, grads)}


@torch.no_grad()
def apply_gradients(state: TrainState, tx, grads: dict[str, torch.Tensor],
                    keep: dict[str, bool] | None = None) -> torch.Tensor:
    """The gradients' mean over the ranks (under a process group), the
    keep-mask on the gradients, the optimizer, the mask on the updates,
    p + u in place, the NonNeg clamp; advances state.step and returns the
    (masked) gradients' global norm."""
    distributed.all_reduce_mean_(list(grads.values()))
    if keep is not None:
        grads = _masked(grads, keep)
    grad_norm = global_norm(grads)
    updates = tx.update(grads, state.opt_state, state.params)
    if keep is not None:
        updates = _masked(updates, keep)
    torch._foreach_add_([state.params[k] for k in updates], list(updates.values()))
    _project_nonneg_mel_mixer(state.params)
    state.step += 1
    return grad_norm


def make_train_step(
    model: torch.nn.Module,
    tx,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    frontend_trainable: bool = True,
    kernel_l2: float = 1e-4,
    compute_dtype: torch.dtype | None = None,
):
    """step(state, x, y) -> (state, {"loss", "grad_norm"}) for a DSCNN
    built with class_activation='none'. frontend_trainable=False zeroes
    the frontend's gradients and updates and keeps its BN on running
    statistics. kernel_l2 is the L2 coefficient (0 disables).
    compute_dtype=torch.bfloat16 is mixed precision (module docstring);
    None is full float32."""

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        model.train(freeze_frontend_bn=not frontend_trainable)
        with full_fp32():
            if compute_dtype is None:
                logits = model(x)
            else:
                # Differentiable casts: the gradients reach the masters.
                p16 = {k: v.to(compute_dtype) for k, v in state.params.items()}
                logits = functional_call(model, p16, (x.to(compute_dtype),)).float()
            loss = loss_fn(logits, y)
            if kernel_l2 > 0:
                loss = loss + conv_kernel_l2(state.params, kernel_l2)
            loss, grads = loss_and_grads(loss, state.params)
        keep = None if frontend_trainable else freeze_mask(state.params, frontend_trainable)
        grad_norm = apply_gradients(state, tx, grads, keep)
        distributed.all_reduce_mean_([loss])
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(model: torch.nn.Module, loss_fn, activation: str = "sigmoid"):
    """step(state, x, y) -> (loss, scores): eval-mode forward, the loss on
    the logits, sigmoid or softmax scores."""

    @torch.no_grad()
    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        model.eval()
        with full_fp32():
            logits = model(x)
            loss = loss_fn(logits, y)
        scores = torch.sigmoid(logits) if activation == "sigmoid" else torch.softmax(logits, -1)
        return loss, scores

    return step


@torch.no_grad()
def infer_block(replicas: dict, x: torch.Tensor, dtype: torch.dtype | None = None):
    """The eval-mode forward of the replica on x's device (TF32 off): float32
    scores of x's rows. dtype=torch.bfloat16 casts x to it (the replicas are
    expected in bf16 already) and the scores back to float32."""
    model = replicas.get(x.device)
    if model is None:
        raise ValueError(f"input on {x.device}, replicas on {list(replicas)}")
    with full_fp32():
        return model(x) if dtype is None else model(x.to(dtype)).float()


def make_infer_fn(model: torch.nn.Module, mesh: list[torch.device] | None = None,
                  dtype: torch.dtype | None = None):
    """x -> scores, eval mode, without gradients (port of make_infer_fn).

    The model is put in eval mode. The mesh (a list of devices,
    parallel/mesh.py::local_mesh; by default the model's device alone)
    gets a replica on each distinct device, x is split into len(mesh) row
    blocks (the width must divide its rows), each block runs on its device,
    and the scores are gathered in row order on mesh[0].
    dtype=torch.bfloat16 casts the input to bf16 (the model is expected
    cast by the caller, as the JAX function expects its variables); the
    scores return float32. `infer.replicas` is the {device: module} the
    function runs.
    """
    mesh = local_mesh([next(model.parameters()).device] if mesh is None else mesh)
    model.eval()
    replicas = replicated(model, mesh)

    def infer(x: torch.Tensor) -> torch.Tensor:
        return gather([infer_block(replicas, b, dtype) for b in shard_batch(x, mesh)], mesh[0])

    infer.replicas = replicas
    return infer
