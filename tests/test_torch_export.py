"""PyTorch port, the portable serving module (conversion/export_program.py):
the torch.export counterpart of the JAX package's StableHLO export.

On the CPU, at the JAX tests' tiny geometry and on the committed flagship
INT8 graph:
- the float program (waveform -> scores, and features -> scores), loaded
  back, within 1e-5 of the eager classifier it was exported from (both
  float32 compositions of the same operations; logits of a model whose
  pred layer is scaled so they vary) and within 1e-5 of JAX's
  own exported StableHLO module on the same waveform (JAX's bytes are not
  compared: the formats differ);
- the INT8 program bit-equal to the eager integer executor fed by the
  composition, as the bit-exact executor promises;
- the batch is static, as in the JAX export; an eager call after an
  export still returns real tensors (the frontend's cached tables are not
  the tracer's); load_serving_fn runs in device.full_fp32().
The convert and deploy verbs' --stablehlo are tested in
tests/test_torch_convert.py and tests/test_torch_deploy.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.conversion import export_stablehlo as JX
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.conversion import export_program as X
from birdnet_stm32_tpu_torch.models.runners import TorchRunner
from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
from tests.int8_fixture import FLAGSHIP_TFLITE
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import one_torch_thread, pair  # noqa: F401

warm_up()

B = 4


def _wave(cfg, n=B, seed=0):
    return np.random.default_rng(seed).normal(0, 0.1, (n, cfg.chunk_samples)).astype(np.float32)


@pytest.fixture(scope="module")
def float_pair():
    """The tiny model, logits head, with its pred layer scaled by 300 in
    both packages: at init its logits span ~3e-3 and its softmax scores sit
    within 4e-4 of uniform, so an unscaled model would pass a 1e-5 gate
    with little to show; scaled, the logits span ~1."""
    jmodel, variables, model, jcfg, cfg = pair(seed=2)
    variables = {**variables, "params": {**variables["params"], "pred": {
        k: np.asarray(v) * np.float32(300) for k, v in variables["params"]["pred"].items()}}}
    with torch.no_grad():
        model.pred.weight.mul_(300)
        model.pred.bias.mul_(300)
    return jmodel, variables, model, jcfg, cfg


def test_float_program_matches_eager_classifier(float_pair):
    _, _, model, _, cfg = float_pair
    blob = X.export_serving_fn(model, cfg, batch_size=B, device="cpu")
    run = X.load_serving_fn(blob)
    wave = _wave(cfg)
    got = run(torch.from_numpy(wave)).numpy()
    classify = make_fused_classifier(TorchRunner(model, cfg, device="cpu"), cfg, device="cpu")
    ref = classify(wave)
    assert got.shape == ref.shape == (B, cfg.num_classes)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert got.std(axis=1).min() > 0.1  # the logits vary: the gate bites


def test_features_program_matches_model(float_pair):
    _, _, model, _, cfg = float_pair
    blob = X.export_serving_fn(model, cfg, batch_size=B, include_frontend=False, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (B, *cfg.input_shape())).astype(np.float32))
    got = X.load_serving_fn(blob)(x)
    with torch.no_grad():
        ref = model(x)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_float_program_matches_jax_module(float_pair):
    jmodel, variables, model, jcfg, cfg = float_pair
    wave = _wave(cfg, seed=3)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jrun = JX.load_serving_fn(JX.export_serving_fn(jmodel, jvars, jcfg, batch_size=B))
    ref = np.asarray(jrun(jnp.asarray(wave)))
    got = X.load_serving_fn(X.export_serving_fn(model, cfg, batch_size=B, device="cpu"))(
        torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_int8_program_bit_equal_to_executor():
    cfg = ModelConfig.load(FLAGSHIP_TFLITE.parent / "model_config.json")
    blob = X.export_int8_serving_fn(FLAGSHIP_TFLITE, cfg, batch_size=2, device="cpu")
    wave = torch.from_numpy(_wave(cfg, n=2, seed=4))
    got = X.load_serving_fn(blob)(wave)
    fwd = build_executor(TFLiteGraph(str(FLAGSHIP_TFLITE)), 2, device="cpu")
    ref = fwd(inputs_for_config(wave, cfg))
    assert type(ref) is torch.Tensor  # the eager path after an export is not traced
    assert got.dtype == ref.dtype == torch.float32 and got.shape == (2, cfg.num_classes)
    assert torch.equal(got, ref)
    assert len(torch.unique(got)) > 5  # the INT8 scores vary (ptp ~0.9 on the flagship)


def test_static_batch_and_full_fp32(float_pair, monkeypatch):
    _, _, model, _, cfg = float_pair
    run = X.load_serving_fn(X.export_serving_fn(model, cfg, batch_size=B, device="cpu"))
    with pytest.raises(Exception):
        run(torch.zeros(B + 1, cfg.chunk_samples))
    entered = []
    real = X.full_fp32

    def spy():
        entered.append(1)
        return real()

    monkeypatch.setattr(X, "full_fp32", spy)
    run(torch.zeros(B, cfg.chunk_samples))
    assert entered == [1]
