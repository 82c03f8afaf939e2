"""PyTorch port, run_qat (quant/qat.py) end to end against the JAX package.

From a run directory of the tiny model's Flax weights, the port's run_qat
against the JAX train_model(qat=True) from the same variables (the JAX
run_qat reads an orbax run directory, which the port does not write), on
the same fixed batches, dropout off on both sides: adam at lr 1e-3 (the
rate at which tests/test_torch_trainer.py finds trajectories that small
differences do not steer), 2 epochs x 3 steps, the epoch losses (train
and validation) within 1e-4 relative. The `<run>_qat` directory holds the
run files, every BN tensor equal to the base run's, and moved kernels; a
dataset of another class count is refused.
"""

import pytest
import torch

from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.training.trainer import train_model as j_train_model
from birdnet_stm32_tpu_torch.models import blocks
from birdnet_stm32_tpu_torch.quant.qat import run_qat
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_trainer import _batches
from tests.torch_train_fixtures import flax_dropout_off, write_run_dir
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

warm_up()


@pytest.fixture(scope="module")
def qat_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("qat")
    _, v, jcfg, cfg = write_run_dir(root / "run")
    train = _batches(cfg, 6)
    val = _batches(cfg, 1, seed=1)
    kw = dict(epochs=2, steps_per_epoch=3, learning_rate=1e-3, multilabel=True, seed=0)
    with flax_dropout_off():
        _, jh = j_train_model(j_build_dscnn(jcfg, class_activation="none"), v, jcfg,
                              iter(train), lambda: val, root / "jax_qat", qat=True, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(blocks, "BLOCK_DROP_RATE", 0.0)  # the blocks' SpatialDropout off
    try:
        _, th = run_qat(root / "run", iter(train), lambda: val, num_classes=3,
                        device="cpu", **kw)
    finally:
        mp.undo()
    return root, jh, th


def test_run_qat_matches_jax(qat_runs):
    root, jh, th = qat_runs
    assert len(jh) == len(th) == 2
    for j, t in zip(jh, th):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-4)
        assert t["val_loss"] == pytest.approx(j["val_loss"], rel=1e-4)
    out = root / "run_qat"
    for name in ("best/state_dict.pt", "last/train_state.pt", "model_config.json",
                 "labels.txt", "train_state.json", "history.csv"):
        assert (out / name).exists(), name
    base = torch.load(root / "run/best/state_dict.pt", weights_only=True)
    tuned = torch.load(out / "best/state_dict.pt", weights_only=True)
    for k, t in tuned.items():
        if "_bn." in k:
            assert torch.equal(t, base[k]), k
    assert not torch.equal(tuned["stem_conv.weight"], base["stem_conv.weight"])


def test_run_qat_checks_the_class_count(qat_runs):
    root, _, _ = qat_runs
    with pytest.raises(ValueError, match="same class set"):
        run_qat(root / "run", iter([]), lambda: [], num_classes=4, device="cpu")
