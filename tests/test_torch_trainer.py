"""PyTorch port, the training loop against the JAX package's.

train_model in both packages from the same variables on the same fixed
batches (SGD, dropout off on both sides, no augmentation: the default
batcher, the frontend only; 3 epochs x 3 steps, then --resume for a
fourth). The two frontends agree within 1e-5 (the port's kernel plain
version against the JAX composition) and each step within the gates of
tests/test_torch_train_step.py. The trajectory must be one that small
differences do not steer: at lr 1e-2 (tiny batches, train-mode BN over 8
values per channel in stage 4) a 1e-7 relative change of the weights
alone moves the port's own sixth-step loss by 3e-3, at lr 1e-3 by 2e-5.
At lr 1e-3 the epoch losses (train and validation) are held within 1e-4
relative. The validation ROC-AUC is not
compared: after 9 steps the eval-mode BN still runs on near-initial
running statistics (momentum 0.99), the scores are near-uniform (val loss
~ln 3) and their ranks are float noise (tests/test_torch_losses_optim.py
holds macro_roc_auc itself).
Both pick the same best epoch, write the same run-directory files (the
weights each in its own format) and history.csv columns, and the resumed
run continues the step count (the cosine schedule and momentum carry on).

The rest is the port alone, as tests/test_trainer.py holds the JAX loop:
the batch-size weighted validation mean, early stopping, the monitor's
watermark across resume, and the final-epoch save when the metric never
goes finite.
"""

import csv
import json

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.training.trainer import train_model as j_train_model
from birdnet_stm32_tpu_torch.training.checkpoint import load_checkpoint, load_train_state
from birdnet_stm32_tpu_torch.training.trainer import train_model
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import flax_dropout_off, pair, port_dropout_off

warm_up()

EPOCHS, STEPS = 3, 3
SGD = dict(learning_rate=1e-3, optimizer="sgd", patience=10, seed=0, steps_per_epoch=STEPS)


def _batches(cfg, n, B=8, seed=0):
    """Tones per class (250 / 900 / 1700 Hz) with noise, one-hot labels."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    out = []
    for _ in range(n):
        lab = rng.integers(0, 3, B)
        w = np.sin(2 * np.pi * np.array([250, 900, 1700])[lab][:, None] * t)
        w = w + 0.1 * rng.normal(size=w.shape)
        out.append(((w / np.abs(w).max(1, keepdims=True)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[lab]))
    return out


def _history(run_dir):
    with open(run_dir / "history.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages: 3 epochs, then a resumed fourth."""
    jmodel, v, model, jcfg, cfg = pair()
    port_dropout_off(model)
    train = _batches(cfg, 4 * STEPS)
    val = _batches(cfg, 1, seed=1) + [tuple(a[:5] for a in _batches(cfg, 1, seed=2)[0])]
    root = tmp_path_factory.mktemp("trainer")
    out = {}
    for epochs, resume in ((EPOCHS, False), (EPOCHS + 1, True)):
        with flax_dropout_off():
            _, jh = j_train_model(jmodel, v, jcfg, iter(train[EPOCHS * STEPS * resume:]),
                                  lambda: val, root / "jax", epochs=epochs, resume=resume, **SGD)
        _, th = train_model(model, cfg, iter(train[EPOCHS * STEPS * resume:]), lambda: val,
                            root / "port", epochs=epochs, resume=resume, device="cpu", **SGD)
        out[resume] = (jh, th)
    return root, out


def test_epoch_losses_match_jax(runs):
    _, out = runs
    for jh, th in out.values():
        assert len(jh) == len(th)
        for j, t in zip(jh, th):
            assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
            assert t["val_loss"] == pytest.approx(j["val_loss"], rel=1e-4)
            assert 0.0 <= t["val_roc_auc"] <= 1.0
    assert len(out[False][1]) == EPOCHS and len(out[True][1]) == 1


def test_run_directory_matches_jax(runs):
    root, _ = runs
    jdir, pdir = root / "jax", root / "port"
    top = lambda d: {p.name for p in d.iterdir()}  # noqa: E731
    assert top(jdir) == top(pdir) >= {"best", "last", "model_config.json", "labels.txt",
                                      "train_state.json", "history.csv", "curves.png"}
    assert (pdir / "best/state_dict.pt").exists() and (pdir / "last/train_state.pt").exists()
    assert (pdir / "labels.txt").read_text() == (jdir / "labels.txt").read_text()
    # The port's sidecar names its architecture besides (the JAX package's
    # ModelConfig.from_dict drops the key).
    assert json.loads((pdir / "model_config.json").read_text()) == {
        **json.loads((jdir / "model_config.json").read_text()), "architecture": "dscnn"}
    jh, ph = _history(jdir), _history(pdir)
    assert list(jh[0]) == list(ph[0]) and len(jh) == len(ph) == EPOCHS + 1
    js, ps = load_train_state(jdir), load_train_state(pdir)
    assert js.keys() == ps.keys() and js["epoch"] == ps["epoch"] == EPOCHS + 1
    assert ps["best_val"] == pytest.approx(js["best_val"], rel=1e-4)
    # The same best epoch: the one whose val_loss is the watermark.
    best = lambda h: int(np.argmin([float(r["val_loss"]) for r in h]))  # noqa: E731
    assert best(jh) == best(ph)


def test_resume_continues_the_step_count(runs):
    root, _ = runs
    last = torch.load(root / "port/last/train_state.pt", weights_only=True)
    assert last["step"] == last["opt_state"]["count"] == (EPOCHS + 1) * STEPS
    model, sd, cfg = load_checkpoint(root / "port", device="cpu")
    assert model.class_activation == "softmax" and cfg.num_classes == 3
    assert set(sd) == set(model.state_dict())


def test_port_loop_rules(tmp_path, capsys):
    """Early stopping, the weighted validation mean, the NaN-metric final
    save, the monitor watermark across resume and the BN-settle warning."""
    _, _, model, _, cfg = pair()
    train = _batches(cfg, 10)
    full, tail = _batches(cfg, 1, seed=1)[0], tuple(a[:3] for a in _batches(cfg, 1, seed=2)[0])
    # Degenerate labels (every val row class 0): the macro AUC is NaN, so the
    # run stops after `patience` stale epochs and saves its final weights.
    one_class = (full[0], np.eye(3, dtype=np.float32)[np.zeros(8, int)])
    seen = []
    _, h = train_model(model, cfg, iter(train), lambda: [one_class], tmp_path / "nan",
                       epochs=5, monitor="val_roc_auc", device="cpu",
                       on_epoch_end=lambda e, m: seen.append(e), **dict(SGD, patience=2))
    assert seen == [0, 1] and len(h) == 2 and np.isnan(h[-1]["val_roc_auc"])
    assert (tmp_path / "nan/best/state_dict.pt").exists()
    out = capsys.readouterr().out
    assert "never improved" in out and "early stopping" in out
    assert "BatchNorm running statistics" in out

    _, _, model, _, cfg = pair()

    def val():
        return [full, tail]

    _, h = train_model(model, cfg, iter(train), val, tmp_path / "stop", epochs=1,
                       learning_rate=0.0, optimizer="sgd", steps_per_epoch=1, device="cpu")
    # The weighted mean over an 8-row and a 3-row batch.
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
    from birdnet_stm32_tpu_torch.parallel.steps import make_eval_step
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn

    step = make_eval_step(model, make_loss_fn(), activation="softmax")
    losses = [float(step(None, frontend_input(torch.from_numpy(w), cfg),
                         torch.from_numpy(y))[0]) for w, y in val()]
    assert h[-1]["val_loss"] == pytest.approx((8 * losses[0] + 3 * losses[1]) / 11, rel=1e-6)
    # Resume under the other monitor: the watermark is reset, and said so.
    train_model(model, cfg, iter(train), val, tmp_path / "stop", epochs=4, resume=True,
                monitor="val_roc_auc", steps_per_epoch=1, device="cpu")
    assert "watermark reset" in capsys.readouterr().out
    assert load_train_state(tmp_path / "stop")["monitor"] == "val_roc_auc"
