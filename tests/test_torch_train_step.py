"""PyTorch port, one train step against the JAX package's.

parallel/steps.py::make_train_step on the CPU against the JAX
make_train_step from the same variables (models/convert.py) on the same
features and labels, with kernel_l2 on: the loss, the gradient norm, every
parameter and every BN running statistic after the step. Dropout is off on
both sides (tests/torch_train_fixtures.py). Train-mode BN divides by the
batch's spread, so the float32 summation-order differences of the two
backends' convolutions (~1e-6 relative) grow to ~1e-4 on the logits; the
gates below are set from that:

- loss within 1e-5 relative, gradient norm within 1e-4 relative;
- sgd: each parameter's update (new - old) within 1e-3 of that tensor's
  largest update;
- adam and adamw: m / (sqrt(v) + eps) is sign(g) wherever |g| is far
  above 1e-8, so one step moves almost every entry by lr whatever the
  gradient's size, and a gradient entry near 0 (a ReLU6 edge, 1-ulp
  noise) can flip sign between backends. The update of 99.9 % of the
  entries is within 1e-3 of lr, and every update is at most
  lr (1 + weight_decay |p|) (+ 1e-3) in size;
- BN running statistics within 1e-4 of each tensor's largest value.

frontend_trainable=False (adamw, whose decay would move the frontend):
the frontend's parameters and its BN statistics stay as they were.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from birdnet_stm32_tpu.parallel.steps import TrainState as JTrainState
from birdnet_stm32_tpu.parallel.steps import make_eval_step as j_make_eval_step
from birdnet_stm32_tpu.parallel.steps import make_train_step as j_make_train_step
from birdnet_stm32_tpu.training.losses import make_loss_fn as j_make_loss_fn
from birdnet_stm32_tpu.training.optimizer import build_optimizer as j_build_optimizer
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.parallel.steps import (
    TrainState,
    conv_kernel_l2,
    freeze_mask,
    make_eval_step,
    make_train_step,
)
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import flax_dropout_off, pair, port_dropout_off

warm_up()

LR = {"sgd": 1e-2, "adam": 1e-3, "adamw": 1e-3}


def _batch(cfg, seed=0, B=8):
    rng = np.random.default_rng(seed)
    x = rng.random((B, *cfg.input_shape())).astype(np.float32)
    y = np.eye(cfg.num_classes, dtype=np.float32)[rng.integers(0, cfg.num_classes, B)]
    return x, y


@functools.lru_cache(maxsize=None)
def _step_pair(optimizer: str, frontend_trainable: bool):
    """(JAX variables before and after, metrics; port state dicts before and
    after, metrics) of one step."""
    jmodel, v, model, jcfg, cfg = pair()
    port_dropout_off(model)
    x, y = _batch(cfg)
    wd = 1e-2 if optimizer == "adamw" else 0.0
    jtx = j_build_optimizer(optimizer, LR[optimizer], weight_decay=wd, gradient_clip_norm=1.0)
    jstep = j_make_train_step(jmodel, jtx, j_make_loss_fn(), donate=False,
                              frontend_trainable=frontend_trainable)
    with flax_dropout_off():
        jstate, jm = jstep(JTrainState.create(v, jtx), x, y, jax.random.key(0))
    after = jax.device_get(jstate.variables())
    tx = build_optimizer(optimizer, LR[optimizer], weight_decay=wd, gradient_clip_norm=1.0)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_train_step(model, tx, make_loss_fn(), frontend_trainable=frontend_trainable)
    state, m = step(TrainState.create(model, tx), torch.from_numpy(x), torch.from_numpy(y))
    return (flax_to_state_dict(v), flax_to_state_dict(after), jax.device_get(jm),
            before, model.state_dict(), m, state)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("optimizer,frontend_trainable",
                         [("sgd", True), ("adam", True), ("adamw", False)])
def test_train_step_matches_jax(optimizer, frontend_trainable):
    jbefore, jafter, jm, before, after, m, state = _step_pair(optimizer, frontend_trainable)
    assert state.step == 1
    assert _rel(m["loss"], jm["loss"]) <= 1e-5
    assert _rel(m["grad_norm"], jm["grad_norm"]) <= 1e-4
    for k, ref in jafter.items():
        if k.endswith("num_batches_tracked"):
            continue
        got = after[k]
        if "running" in k:
            assert (got - ref).abs().max() <= 1e-4 * ref.abs().max(), k
            continue
        ju, u = ref - jbefore[k], got - before[k]
        if optimizer == "sgd":
            assert (u - ju).abs().max() <= 1e-3 * ju.abs().max(), k
        else:
            bound = LR[optimizer] * (1 + 1e-3) * (1 + 1e-2 * before[k].abs().max())
            assert u.abs().max() <= bound, k
    if optimizer != "sgd":
        d = torch.cat([((after[k] - before[k]) - (jafter[k] - jbefore[k])).flatten()
                       for k in jafter if "running" not in k and "num_batches" not in k])
        assert (d.abs() <= 1e-3 * LR[optimizer]).float().mean() >= 0.999
    if not frontend_trainable:
        for k in jafter:
            if k.startswith("audio_frontend."):
                assert torch.equal(after[k], before[k]) and torch.equal(jafter[k], jbefore[k]), k


def test_mel_mixer_stays_nonnegative():
    """The NonNeg clamp after the update: a large SGD step on the hybrid mixer
    leaves no negative entry (the JAX step clamps the same way)."""
    *_, after, _, _ = _step_pair("sgd", True)
    assert (after["audio_frontend.mel_mixer"] >= 0).all()


def test_conv_kernel_l2_and_freeze_mask():
    """The L2 term covers exactly the block convolutions (not stem, emb,
    head or frontend), as the JAX conv_kernel_l2 does; the freeze mask drops
    the frontend, and with freeze_bn every BN scale and bias."""
    from birdnet_stm32_tpu.parallel.steps import conv_kernel_l2 as j_conv_kernel_l2

    _, v, model, _, _ = pair(use_se=True, use_inverted_residual=True)
    params = dict(model.named_parameters())
    got = float(conv_kernel_l2(params, 1e-4).detach())
    assert got == pytest.approx(float(j_conv_kernel_l2(v["params"], 1e-4)), rel=1e-6)
    keep = freeze_mask(params, frontend_trainable=False, freeze_bn=True)
    assert not keep["audio_frontend.mel_mixer"] and not keep["stem_bn.weight"]
    assert keep["stem_conv.weight"] and keep["pred.weight"] and keep["stage1_ir1_se_expand.weight"]


def test_eval_step_matches_jax():
    """Eval mode (running statistics): loss and sigmoid / softmax scores."""
    jmodel, v, model, _, cfg = pair()
    x, y = _batch(cfg, seed=1)
    for activation in ("sigmoid", "softmax"):
        jloss, jscores = jax.device_get(j_make_eval_step(jmodel, j_make_loss_fn(),
                                                         activation=activation)(
            JTrainState.create(v, optax.sgd(0.1)), x, y))
        loss, scores = make_eval_step(model, make_loss_fn(), activation=activation)(
            None, torch.from_numpy(x), torch.from_numpy(y))
        assert _rel(loss, jloss) <= 1e-5
        np.testing.assert_allclose(scores.numpy(), jscores, rtol=0, atol=5e-5)
