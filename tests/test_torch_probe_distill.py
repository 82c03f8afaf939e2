"""PyTorch port, the linear probe, distillation and a tuner trial's model
against the JAX package's.

- run_linear_probe: the port with JAX's head injected (its LeCun-normal
  draw comes from threefry) against the JAX run_linear_probe, 1 epoch x 2
  adam steps at lr 1e-3 on the same features, dropout off on both sides:
  the epoch's train and validation loss within 1e-5 relative, the head's
  update within 1e-3 of lr (adam moves each entry by about lr), the
  backbone bit-identical; `run_dir` holds the probe's weights, config and
  labels. With no finite validation loss the final state is saved.
- distillation: make_distillation_loss on [B, 2C] targets within 1e-6
  relative of JAX's (softmax and multilabel heads); make_teacher_batcher
  with the tiny model as the teacher within 1e-5 of JAX's; run_distillation
  end to end on the port.
- the tuner's search space reaches SE, inverted-residual and
  attention-pooling DS-CNNs in train mode: one make_train_step of such a
  model against JAX's at tests/test_torch_train_step.py's gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.ops.frontend import inputs_for_config as j_inputs_for_config
from birdnet_stm32_tpu.parallel.steps import TrainState as JTrainState
from birdnet_stm32_tpu.parallel.steps import make_train_step as j_make_train_step
from birdnet_stm32_tpu.training.distillation import (
    make_distillation_loss as j_make_distillation_loss,
)
from birdnet_stm32_tpu.training.distillation import make_teacher_batcher as j_make_teacher_batcher
from birdnet_stm32_tpu.training.linear_probe import make_probe as j_make_probe
from birdnet_stm32_tpu.training.linear_probe import run_linear_probe as j_run_linear_probe
from birdnet_stm32_tpu.training.losses import make_loss_fn as j_make_loss_fn
from birdnet_stm32_tpu.training.optimizer import build_optimizer as j_build_optimizer
from birdnet_stm32_tpu_torch.models import blocks
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
from birdnet_stm32_tpu_torch.training import linear_probe
from birdnet_stm32_tpu_torch.training.checkpoint import load_checkpoint
from birdnet_stm32_tpu_torch.training.distillation import (
    make_distillation_loss,
    make_teacher_batcher,
    run_distillation,
)
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer
from birdnet_stm32_tpu_torch.utils.prng import generator
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_trainer import _batches
from tests.torch_train_fixtures import flax_dropout_off, pair, port_dropout_off
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

warm_up()

NEW = ["x", "y"]


def _probe_batches(cfg, n, seed):
    """Features of tone batches, relabelled into the two new classes."""
    out = []
    for w, y in _batches(cfg, n, seed=seed):
        y2 = np.stack([y[:, 0], y[:, 1] + y[:, 2]], axis=1).astype(np.float32)
        out.append((frontend_input(torch.from_numpy(w), cfg).numpy(), y2))
    return out


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe")
    _, v, model, jcfg, cfg = pair()
    train, val = _probe_batches(cfg, 2, 0), _probe_batches(cfg, 1, 1)
    kw = dict(epochs=1, steps_per_epoch=2, learning_rate=1e-3, seed=0)
    with flax_dropout_off():
        jbest, jh = j_run_linear_probe(v, jcfg, NEW, iter(train), lambda: val, root / "jax", **kw)
    jhead = j_make_probe(v, jcfg, NEW, jax.random.key(0))[1]["params"]["pred"]
    make_probe = linear_probe.make_probe

    def with_jax_head(*args, **kwargs):
        probe, new_cfg = make_probe(*args, **kwargs)
        with torch.no_grad():
            probe.pred.weight.copy_(torch.from_numpy(np.asarray(jhead["kernel"]).T))
        return probe, new_cfg

    sd = model.state_dict()
    mp = pytest.MonkeyPatch()
    mp.setattr(linear_probe, "make_probe", with_jax_head)
    mp.setattr(blocks, "BLOCK_DROP_RATE", 0.0)
    try:
        best, h = linear_probe.run_linear_probe(sd, cfg, NEW, iter(train), lambda: val,
                                                root / "port", device="cpu", **kw)
    finally:
        mp.undo()
    return root, sd, jhead, jax.device_get(jbest), jh, best, h


def test_probe_matches_jax(probes):
    _, _, jhead, jbest, jh, best, h = probes
    assert h[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    assert h[0]["val_loss"] == pytest.approx(jh[0]["val_loss"], rel=1e-5)
    w0 = np.asarray(jhead["kernel"]).T
    ju = np.asarray(jbest["params"]["pred"]["kernel"]).T - w0
    u = best["pred.weight"].numpy() - w0
    assert np.abs(u - ju).max() <= 1e-3 * 1e-3
    np.testing.assert_allclose(best["pred.bias"].numpy(), jbest["params"]["pred"]["bias"],
                               rtol=0, atol=1e-6)


def test_probe_freezes_the_backbone_and_writes_the_run(probes):
    root, sd, _, _, _, best, _ = probes
    linear_probe.assert_backbone_frozen(sd, best)
    model, saved, cfg = load_checkpoint(root / "port", device="cpu")
    assert cfg.num_classes == 2 and cfg.class_names == NEW
    assert (root / "port/labels.txt").read_text().split() == NEW
    assert all(torch.equal(saved[k], best[k]) for k in best)
    with pytest.raises(AssertionError, match="moved"):
        linear_probe.assert_backbone_frozen(sd, {**best, "stem_conv.weight": sd[
            "stem_conv.weight"] + 1e-7})


def test_probe_head_draw_and_final_save(tmp_path):
    _, _, model, _, cfg = pair()
    sd = model.state_dict()
    a, _ = linear_probe.make_probe(sd, cfg, NEW, torch.Generator().manual_seed(3), device="cpu")
    b, new_cfg = linear_probe.make_probe(sd, cfg, NEW, torch.Generator().manual_seed(3),
                                         device="cpu")
    w = a.pred.weight.detach()
    std = (1.0 / w.shape[1]) ** 0.5 / linear_probe._TRUNC_STD
    assert torch.equal(w, b.pred.weight) and w.abs().max() <= 2 * std
    assert new_cfg.class_names == NEW and torch.equal(a.pred.bias, torch.zeros(2))
    # No finite validation loss: the final state is saved all the same.
    train = _probe_batches(cfg, 1, 2)
    best, h = linear_probe.run_linear_probe(sd, cfg, NEW, iter(train), lambda: [],
                                            tmp_path / "probe", epochs=1, steps_per_epoch=1,
                                            device="cpu")
    assert np.isnan(h[0]["val_loss"]) and (tmp_path / "probe/best/state_dict.pt").exists()


@pytest.mark.parametrize("multilabel", [False, True])
def test_distillation_loss_matches_jax(multilabel):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (8, 5)).astype(np.float32)
    hard = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    soft = rng.dirichlet(np.ones(5), 8).astype(np.float32)
    y = np.concatenate([hard, soft], 1)
    ref = float(j_make_distillation_loss(5, 0.3, 2.0, multilabel)(jnp.asarray(logits),
                                                                   jnp.asarray(y)))
    got = float(make_distillation_loss(5, 0.3, 2.0, multilabel)(torch.from_numpy(logits),
                                                                 torch.from_numpy(y)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_teacher_batcher_matches_jax():
    jmodel, v, model, jcfg, cfg = pair()
    teacher = build_dscnn(cfg, class_activation="softmax", device="cpu")
    teacher.load_state_dict(model.state_dict())
    jteacher = j_build_dscnn(jcfg, class_activation="softmax")
    wave, labels = _batches(cfg, 1)[0]
    ref = j_make_teacher_batcher(
        lambda k, w, l: (j_inputs_for_config(w, jcfg), l),
        jax.jit(lambda x: jteacher.apply(v, x, train=False)))(
        jax.random.key(0), jnp.asarray(wave), jnp.asarray(labels))
    got = make_teacher_batcher(lambda g, w, l: (frontend_input(w, cfg), l),
                               lambda x: teacher.eval()(x))(
        generator(0), torch.from_numpy(wave), torch.from_numpy(labels))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-5)
    assert got[1].shape == (8, 6) and not got[1].requires_grad


def test_run_distillation_end_to_end(tmp_path):
    _, _, teacher_model, _, cfg = pair()
    teacher = build_dscnn(cfg, class_activation="softmax", device="cpu")
    teacher.load_state_dict(teacher_model.state_dict())
    teacher.eval()
    student = init_model(build_dscnn(cfg, class_activation="none", device="cpu"), seed=1)
    train, val = _batches(cfg, 2), _batches(cfg, 1, seed=1)
    _, h = run_distillation(student, cfg, teacher, iter(train), lambda: val,
                            tmp_path / "student", alpha=0.5, temperature=3.0, epochs=1,
                            steps_per_epoch=2, device="cpu")
    assert len(h) == 1 and all(np.isfinite(e["loss"]) and np.isfinite(e["val_loss"]) for e in h)
    assert 0.0 <= h[-1]["val_roc_auc"] <= 1.0
    assert (tmp_path / "student/best/state_dict.pt").exists()
    _, _, scfg = load_checkpoint(tmp_path / "student", device="cpu")
    assert scfg.num_classes == 3


def test_tuner_trial_model_step_matches_jax():
    """SE + inverted residual + attention pooling, trained (sgd, lr 1e-2).
    An inverted-residual block ends in its project BN with no nonlinearity,
    and the next layer is a linear conv into a train-mode BN, which removes
    any per-channel shift: the project BN's bias gets a gradient of float
    noise (~0), so per-tensor relative gates do not apply. Held: the loss
    within 1e-4 relative (read: 3.1e-5), the whole update within 1e-3 in L2
    (read: 2.8e-4), every entry within 1e-3 of the model's largest update
    (read: 4.8e-4), the BN statistics within 1e-5 in L2 (read: 5.3e-7)."""
    jmodel, v, model, _, cfg = pair(use_se=True, use_inverted_residual=True,
                                    use_attention_pooling=True)
    port_dropout_off(model)
    rng = np.random.default_rng(0)
    x = rng.random((8, *cfg.input_shape())).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jtx = j_build_optimizer("sgd", 1e-2, gradient_clip_norm=1.0)
    with flax_dropout_off():
        js, jm = j_make_train_step(jmodel, jtx, j_make_loss_fn(), donate=False)(
            JTrainState.create(v, jtx), x, y, jax.random.key(0))
    jbefore, jafter = flax_to_state_dict(v), flax_to_state_dict(jax.device_get(js.variables()))
    tx = build_optimizer("sgd", 1e-2, gradient_clip_norm=1.0)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    _, m = make_train_step(model, tx, make_loss_fn())(TrainState.create(model, tx),
                                                      torch.from_numpy(x), torch.from_numpy(y))
    after = model.state_dict()
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert any(k.startswith("attn_pool_score") for k in after)
    keys = [k for k in jafter if not k.endswith("num_batches_tracked") and "running" not in k]
    u = torch.cat([(after[k] - before[k]).flatten() for k in keys])
    ju = torch.cat([(jafter[k] - jbefore[k]).flatten() for k in keys])
    assert float((u - ju).norm() / ju.norm()) <= 1e-3
    assert float((u - ju).abs().max()) <= 1e-3 * float(ju.abs().max())
    stats = [k for k in jafter if "running" in k]
    s, js_ = (torch.cat([t[k].flatten() for k in stats]) for t in (after, jafter))
    assert float((s - js_).norm() / js_.norm()) <= 1e-5
