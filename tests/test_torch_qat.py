"""PyTorch port, quantization-aware training (quant/qat.py) against the JAX
package's.

One make_qat_train_step from the same variables on the same features and
labels, with the activation fake-quant off and on, for sgd and adam,
dropout off on both sides (tests/torch_train_fixtures.py). The gates are
tests/test_torch_train_step.py's: the loss within 1e-5 relative; sgd:
each parameter's update within 1e-3 of that tensor's largest update; adam:
every update at most lr (+ 1e-3) in size and 99.9 % of the entries within
1e-3 of lr of JAX's. Every BN is frozen: its running statistics and its
scale and bias are unchanged bit for bit, on both sides.

With the activation fake-quant on, a window of zeroed codes makes a ReLU6
pre-activation of exactly 0; there JAX's min(max(x, 0), 6) passes half the
gradient. The port's relu6 does the same under autograd (torch.clamp passes
all of it, which moved the tiny model's whole update by 1.4 % in L2 against
JAX's, 6.8e-7 after).

run_qat end to end: tests/test_torch_qat_run.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.parallel.steps import TrainState as JTrainState
from birdnet_stm32_tpu.quant.qat import make_qat_train_step as j_make_qat_train_step
from birdnet_stm32_tpu.training.losses import make_loss_fn as j_make_loss_fn
from birdnet_stm32_tpu.training.optimizer import build_optimizer as j_build_optimizer
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.parallel.steps import TrainState
from birdnet_stm32_tpu_torch.quant.qat import make_qat_train_step
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import flax_dropout_off, pair, port_dropout_off
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

warm_up()

LR = {"sgd": 1e-2, "adam": 1e-3}


def _features(cfg, seed=0, B=8):
    rng = np.random.default_rng(seed)
    x = rng.random((B, *cfg.input_shape())).astype(np.float32)
    y = np.eye(cfg.num_classes, dtype=np.float32)[rng.integers(0, cfg.num_classes, B)]
    return x, y


@functools.lru_cache(maxsize=None)
def _step_pair(optimizer: str, act_fq: bool):
    jmodel, v, model, _, cfg = pair()
    port_dropout_off(model)
    x, y = _features(cfg)
    jtx = j_build_optimizer(optimizer, LR[optimizer], gradient_clip_norm=1.0)
    jstep = j_make_qat_train_step(jmodel, jtx, j_make_loss_fn(), donate=False, act_fq=act_fq)
    with flax_dropout_off():
        jstate, jm = jstep(JTrainState.create(v, jtx), x, y, jax.random.key(0))
    tx = build_optimizer(optimizer, LR[optimizer], gradient_clip_norm=1.0)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_qat_train_step(model, tx, make_loss_fn(), act_fq=act_fq)
    state, m = step(TrainState.create(model, tx), torch.from_numpy(x), torch.from_numpy(y))
    return (flax_to_state_dict(v), flax_to_state_dict(jax.device_get(jstate.variables())),
            jax.device_get(jm), before, model.state_dict(), m, state)


@pytest.mark.parametrize("act_fq", [False, True])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_qat_step_matches_jax(optimizer, act_fq):
    jbefore, jafter, jm, before, after, m, state = _step_pair(optimizer, act_fq)
    assert state.step == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    lr = LR[optimizer]
    diffs = []
    for k, ref in jafter.items():
        if k.endswith("num_batches_tracked"):
            continue
        got = after[k]
        if "running" in k or "_bn." in k:
            # Frozen BN: statistics, scale and bias as they were, bit for bit.
            assert torch.equal(got, before[k]) and torch.equal(ref, jbefore[k]), k
            continue
        ju, u = ref - jbefore[k], got - before[k]
        if optimizer == "sgd":
            assert (u - ju).abs().max() <= 1e-3 * ju.abs().max(), k
        else:
            assert u.abs().max() <= lr * (1 + 1e-3), k
            diffs.append((u - ju).flatten())
    if diffs:
        assert (torch.cat(diffs).abs() <= 1e-3 * lr).float().mean() >= 0.999


def test_qat_step_moves_only_unfrozen_parameters():
    """The kernels move; BN scale and bias are masked on the gradients and
    the updates (adam with decoupled weight decay would move them
    otherwise)."""
    _, _, model, _, cfg = pair()
    port_dropout_off(model)
    x, y = map(torch.from_numpy, _features(cfg, seed=3))
    tx = build_optimizer("adamw", 1e-3, weight_decay=1e-2)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_qat_train_step(model, tx, make_loss_fn())
    step(TrainState.create(model, tx), x, y)
    after = model.state_dict()
    for k, t in after.items():
        moved = not torch.equal(t, before[k])
        frozen = "_bn." in k or k.endswith("num_batches_tracked")
        assert moved != frozen, k


def test_relu6_tie_gradient_matches_jax():
    """At x == 0 and x == 6 the gradient is half, as JAX's min(max(x, 0), 6)."""
    from birdnet_stm32_tpu.models.blocks import relu6 as j_relu6
    from birdnet_stm32_tpu_torch.models.blocks import relu6

    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    ref = np.asarray(jax.grad(lambda v: j_relu6(v).sum())(x))
    t = torch.from_numpy(x).requires_grad_()
    relu6(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), ref)
    np.testing.assert_array_equal(ref, [0.0, 0.5, 1.0, 0.5, 0.0])
    with torch.no_grad():
        assert torch.equal(relu6(t), torch.clamp(t, 0.0, 6.0))
