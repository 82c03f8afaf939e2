"""PyTorch port, the LR finder and the tuner against the JAX package's.

- run_lr_finder: the same sweep (the first 12 steps of min 1e-9, max 1,
  40 steps) from the same variables on the same batches (the features of
  tests/test_torch_trainer.py's tone batches), dropout off on both sides.
  The learning rates are bit-equal (the same float64 arithmetic). The
  losses (raw and smoothed) are within 1e-4 relative over the first 6
  steps (read with one torch thread: <= 5.3e-5; the seventh reads 1.3e-4,
  6.2e-5 with eight threads). Past them the sweep is plain SGD without
  clipping on gradients of norm ~5000 (the tiny model's train-mode BN at
  initialisation), a trajectory that float32 summation order steers: from
  lr 1e-7 on, the two sweeps' losses part by 7-47 %. suggest_lr equals
  JAX's on the same curves; the caller's model is left as it was.
- tuner: the numpy-only copy. For one seed, a study of 12 trials (5
  random startup trials, then TPE proposals) with a deterministic
  objective that reports per-epoch values (median pruning) gives the same
  proposals, values and pruning decisions as JAX's, bit for bit, and the
  same best_params.json.
"""

import json

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.training import tuner as j_tuner
from birdnet_stm32_tpu.training.losses import make_loss_fn as j_make_loss_fn
from birdnet_stm32_tpu.training.lr_finder import run_lr_finder as j_run_lr_finder
from birdnet_stm32_tpu.training.lr_finder import suggest_lr as j_suggest_lr
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
from birdnet_stm32_tpu_torch.training import tuner
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.lr_finder import run_lr_finder, suggest_lr
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_trainer import _batches as wave_batches
from tests.torch_train_fixtures import flax_dropout_off, pair, port_dropout_off
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

warm_up()

# The first 12 steps of a 1e-9 -> 1 sweep over 40 steps (the same rates).
SWEEP = dict(min_lr=1e-9, max_lr=1e-9 * 1e9 ** (11 / 39), num_steps=12)
STABLE_STEPS = 6


@pytest.fixture(scope="module")
def sweeps():
    jmodel, v, model, _, cfg = pair()
    port_dropout_off(model)
    batches = [(frontend_input(torch.from_numpy(w), cfg).numpy(), y)
               for w, y in wave_batches(cfg, SWEEP["num_steps"])]
    with flax_dropout_off():
        ref = j_run_lr_finder(jmodel, v, iter(batches), j_make_loss_fn(), **SWEEP)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = run_lr_finder(model, iter(batches), make_loss_fn(), **SWEEP)
    return ref, got, before, model


def test_lr_finder_matches_jax(sweeps):
    ref, got, _, _ = sweeps
    n = min(len(got["lrs"]), len(ref["lrs"]))
    assert n > STABLE_STEPS and got["lrs"][:n] == ref["lrs"][:n]
    for key in ("losses", "smoothed"):
        np.testing.assert_allclose(got[key][:STABLE_STEPS], ref[key][:STABLE_STEPS], rtol=1e-4)
    assert min(got["lrs"]) <= got["suggested_lr"] <= max(got["lrs"])


def test_lr_finder_leaves_the_model(sweeps):
    _, _, before, model = sweeps
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_suggest_lr_matches_jax(sweeps):
    ref, got, _, _ = sweeps
    for curve in (ref, got):
        assert suggest_lr(curve["lrs"], curve["smoothed"]) == j_suggest_lr(
            curve["lrs"], curve["smoothed"])
    assert ref["suggested_lr"] == j_suggest_lr(ref["lrs"], ref["smoothed"])
    for n in range(5):  # fewer than 5 points: the middle one, or 1e-3
        assert suggest_lr(ref["lrs"][:n], ref["smoothed"][:n]) == j_suggest_lr(
            ref["lrs"][:n], ref["smoothed"][:n])


def _objective(trial):
    """Deterministic in the params; reports three epochs."""
    p = trial.params
    score = (p["alpha"] - 0.8) ** 2 + abs(np.log10(p["learning_rate"]) + 3.0)
    score += 0.1 * p["depth_multiplier"] + (0.2 if p["use_se"] else 0.0)
    for epoch in range(3):
        trial.report(1.0 / (1.0 + score) * (epoch + 1) / 3.0, epoch)
    return 1.0 / (1.0 + score)


@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_study_matches_jax(sampler):
    studies = []
    for mod in (tuner, j_tuner):
        study = mod.Study(seed=3, sampler=sampler)
        study.optimize(_objective, 12)
        studies.append([(t.number, t.params, t.value, t.pruned, t.intermediate)
                        for t in study.trials])
    assert studies[0] == studies[1]
    assert any(pruned for *_, pruned, _ in studies[0])  # the pruner fired


def test_tpe_propose_and_sample_params_match_jax():
    rng_a, rng_b = np.random.default_rng(11), np.random.default_rng(11)
    assert tuner.sample_params(rng_a) == j_tuner.sample_params(rng_b)
    trials = [tuner.Trial(i, tuner.sample_params(np.random.default_rng(i)), value=0.1 * i)
              for i in range(8)]
    jtrials = [j_tuner.Trial(t.number, dict(t.params), value=t.value) for t in trials]
    assert tuner.tpe_propose(rng_a, trials) == j_tuner.tpe_propose(rng_b, jtrials)


def test_run_tuning_writes_the_same_best_params(tmp_path):
    best = tuner.run_tuning(_objective, 8, tmp_path / "port", seed=5)
    jbest = j_tuner.run_tuning(_objective, 8, tmp_path / "jax", seed=5)
    text = (tmp_path / "port/best_params.json").read_text()
    assert text == (tmp_path / "jax/best_params.json").read_text()
    assert json.loads(text)["trial"] == best.number == jbest.number
