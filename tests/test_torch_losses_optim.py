"""PyTorch port, losses, optimizers, the cosine schedule and macro ROC-AUC
against the JAX package (and sklearn).

Losses: every function of training/losses.py against the JAX one on the
same seeded logits and labels, within 1e-6 relative (float32 on both
sides; log-sum-exp and log-sigmoid differ by an ulp or two).

Optimizers: one update of adam, sgd and adamw, each behind the per-tensor
clip, against optax on the same gradients and parameters (some tensors
clipped, some not), then a second update from the carried state: updates
within 1e-6 relative to lr (they are lr-sized or smaller), moments within
1e-6 relative. The gradients are kept far from 0, where adam's
m / (sqrt(v) + eps) would turn 1-ulp differences into lr-sized ones.
The cosine schedule within 1e-6 relative of optax's at every count.

macro_roc_auc is numpy only (the card machine has no scikit-learn): equal
to sklearn's roc_auc_score averaged over the non-degenerate columns
within 1e-12, on scores with ties and with degenerate columns.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birdnet_stm32_tpu.training import losses as J
from birdnet_stm32_tpu.training.optimizer import build_optimizer as j_build_optimizer
from birdnet_stm32_tpu.training.optimizer import cosine_schedule as j_cosine_schedule
from birdnet_stm32_tpu.training.trainer import macro_roc_auc as j_macro_roc_auc
from birdnet_stm32_tpu_torch.training import losses as P
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer, cosine_schedule
from birdnet_stm32_tpu_torch.training.trainer import macro_roc_auc
from tests.test_torch_cpu_warmup import warm_up

warm_up()

RTOL = 1e-6


def _data(seed=0, B=16, C=5, soft=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (B, C)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    if soft:
        labels = np.maximum(labels, np.eye(C, dtype=np.float32)[rng.integers(0, C, B)])
    weights = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return logits, labels, weights


CASES = [
    ("cce", lambda m, l, y, w: m.categorical_crossentropy(l, y)),
    ("cce_weighted_smoothed", lambda m, l, y, w: m.categorical_crossentropy(
        l, y, class_weights=w, label_smoothing=0.1)),
    ("bce", lambda m, l, y, w: m.binary_crossentropy(l, y)),
    ("bce_weighted_smoothed", lambda m, l, y, w: m.binary_crossentropy(
        l, y, class_weights=w, label_smoothing=0.2)),
    ("focal", lambda m, l, y, w: m.binary_focal_loss(l, y, gamma=2.0)),
    ("focal_smoothed", lambda m, l, y, w: m.binary_focal_loss(l, y, gamma=1.5,
                                                             label_smoothing=0.1)),
    ("distillation", lambda m, l, y, w: m.distillation_loss(
        l, y, np.float32(0.05) + 0.9 * y / y.sum(-1, keepdims=True), alpha=0.3)),
    ("distillation_multilabel", lambda m, l, y, w: m.distillation_loss(
        l, y, np.float32(0.05) + 0.9 * y / y.sum(-1, keepdims=True), multilabel=True)),
]


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
def test_loss_matches_jax(name, fn, soft):
    logits, labels, w = _data(soft=soft)
    ref = float(fn(J, jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w)))
    t = torch.from_numpy
    if name.startswith("distillation"):
        soft_t = np.float32(0.05) + 0.9 * labels / labels.sum(-1, keepdims=True)
        got = float(P.distillation_loss(t(logits), t(labels), t(soft_t),
                                         **({"alpha": 0.3} if name == "distillation"
                                            else {"multilabel": True})))
    else:
        got = float(fn(P, t(logits), t(labels), t(w)))
    assert got == pytest.approx(ref, rel=RTOL)


@pytest.mark.parametrize("multilabel,focal_gamma,smoothing",
                         [(False, None, 0.0), (False, None, 0.1), (True, None, 0.1),
                          (True, 2.0, 0.1)])
def test_make_loss_fn_matches_jax(multilabel, focal_gamma, smoothing):
    logits, labels, w = _data(seed=3, soft=multilabel)
    ref = J.make_loss_fn(multilabel=multilabel, focal_gamma=focal_gamma,
                         label_smoothing=smoothing, class_weights=w)(
        jnp.asarray(logits), jnp.asarray(labels))
    got = P.make_loss_fn(multilabel=multilabel, focal_gamma=focal_gamma,
                         label_smoothing=smoothing, class_weights=w)(
        torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(got) == pytest.approx(float(ref), rel=RTOL)


def test_smooth_labels_matches_jax():
    _, labels, _ = _data()
    for binary in (False, True):
        np.testing.assert_allclose(
            P.smooth_labels(torch.from_numpy(labels), 0.1, binary=binary).numpy(),
            np.asarray(J.smooth_labels(jnp.asarray(labels), 0.1, binary=binary)),
            rtol=0, atol=0)


def _params_and_grads(seed):
    """Named tensors, two of them with gradient norms above the clip of 1.0;
    |g| >= 1e-3 everywhere."""
    rng = np.random.default_rng(seed)
    shapes = {"a.weight": (4, 3, 3, 3), "b.weight": (8,), "c.bias": (5, 7)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = {}
    for i, (k, s) in enumerate(shapes.items()):
        g = rng.uniform(1e-3, 1.0, s) * rng.choice([-1.0, 1.0], s) * (0.05 if i == 1 else 1.0)
        grads[k] = g.astype(np.float32)
    return params, grads


@pytest.mark.parametrize("name", ["adam", "sgd", "adamw"])
def test_optimizer_update_matches_optax(name):
    lr = 3e-3
    schedule = cosine_schedule(lr, 2, 5)
    jtx = j_build_optimizer(name, j_cosine_schedule(lr, 2, 5), weight_decay=1e-2,
                            gradient_clip_norm=1.0)
    tx = build_optimizer(name, schedule, weight_decay=1e-2, gradient_clip_norm=1.0)
    params, grads = _params_and_grads(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, state = jtx.init(jparams), tx.init(tparams)
    for it in range(2):
        _, grads = _params_and_grads(it + 1)
        jupd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        upd = tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, tparams)
        for k in params:
            np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]), rtol=0,
                                       atol=RTOL * lr)
            jparams[k] = jparams[k] + jupd[k]
            tparams[k] = tparams[k] + upd[k]
    assert state["count"] == 2
    moments = ({"trace": jstate[-1][0].trace} if name == "sgd"
               else {"mu": jstate[-1][0].mu, "nu": jstate[-1][0].nu})
    for m, tree in moments.items():
        for k in params:
            ref = np.asarray(tree[k])
            np.testing.assert_allclose(state[m][k].numpy(), ref, rtol=RTOL,
                                       atol=RTOL * np.abs(ref).max())


def test_cosine_schedule_matches_optax():
    s, j = cosine_schedule(1e-3, 7, 13), j_cosine_schedule(1e-3, 7, 13)
    for count in (0, 1, 5, 45, 90, 91, 200):
        assert s(count) == pytest.approx(float(j(count)), rel=RTOL, abs=1e-12)
    assert s(0) == pytest.approx(1e-3) and s(91) == 0.0


def test_invalid_optimizer():
    with pytest.raises(ValueError, match="Invalid optimizer"):
        build_optimizer("rmsprop", 1e-3)


def test_macro_roc_auc_matches_sklearn():
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(5)
    y = (rng.random((60, 6)) < 0.3).astype(np.float32)
    y[:, 4] = 0.0  # never positive: skipped
    y[:, 5] = 1.0  # never negative: skipped
    scores = np.round(rng.random((60, 6)), 1).astype(np.float32)  # many ties
    ref = np.mean([roc_auc_score(y[:, c], scores[:, c]) for c in range(4)])
    assert macro_roc_auc(y, scores) == pytest.approx(ref, rel=1e-12, abs=1e-12)
    assert macro_roc_auc(y, scores) == pytest.approx(j_macro_roc_auc(y, scores), abs=1e-12)
    assert np.isnan(macro_roc_auc(y[:, 4:], scores[:, 4:]))
    all_tied = np.full((60, 6), 0.5, np.float32)
    assert macro_roc_auc(y, all_tied) == pytest.approx(0.5)
