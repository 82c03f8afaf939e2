"""The plain reference against the port on the CPU at a small batch, the
INT8 reference against the TFLite interpreter's golden scores, and the
control (the reference one precision lower) failing the limit."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import correctness, traffic
from gpubench.reference import dscnn, frontend, int8
from gpubench.weights import seeded_state

ROOT = Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "tests/goldens/torch_int8_flagship_scores.npz"
INT8 = json.loads((ROOT / "gpubench/configs/flagship-int8.json").read_text())
BF16 = json.loads((ROOT / "gpubench/configs/flagship-bf16.json").read_text())
MIX = json.loads((ROOT / "gpubench/traffic/closed-b64-int16.json").read_text())
MIX48 = json.loads((ROOT / "gpubench/traffic/closed-b64-f32-48k.json").read_text())
ROWS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_pool(mix, config, seed=7):
    return traffic.make_pool({**mix, "rows": ROWS, "pool": 1}, config, seed)


def test_int8_reference_matches_the_interpreter_golden():
    # tests/int8_fixture.py::flagship_features(8): uniform [0, 1) features, seed 0.
    x = np.random.default_rng(0).uniform(0, 1, (8, 257, 256, 1)).astype(np.float32)
    got = int8.run(int8.load(ROOT / INT8["tflite"]), x, threads=2)
    np.testing.assert_array_equal(got, np.load(GOLDEN)["scores"])


@pytest.mark.parametrize("mix", [MIX, MIX48], ids=["int16", "f32-48k"])
def test_int8_reference_matches_the_port_on_spectrograms(mix):
    # The port's integer executor on the CPU over the reference's features:
    # the two agree code for code (entry ties aside, which these rows avoid
    # or carry to no score).
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor

    feats = frontend.features(small_pool(mix, INT8)[0], INT8, mix)
    port = build_executor(TFLiteGraph(ROOT / INT8["tflite"]), ROWS, device="cpu")(
        torch.from_numpy(feats)).numpy()
    ref = int8.run(int8.load(ROOT / INT8["tflite"]), feats, threads=2)
    assert ref.shape == port.shape == (ROWS, INT8["num_classes"])
    assert np.abs(ref - port).max() <= 1 / 256


def test_requantization_rounds_ties_up():
    # MultiplyByQuantizedMultiplier by 1/2 (q 2^30, shift 0): x / 2 rounded,
    # ties toward +inf, as the interpreter's optimized kernels round.
    x = np.arange(-5, 6)
    np.testing.assert_array_equal(int8.multiply_by_quantized_multiplier(x, 1 << 30, 0),
                                  np.floor(x / 2 + 0.5))
    # by 1/8 (q 2^30, shift -2): a right shift of 2 after the high multiply.
    x = np.arange(-20, 21)
    np.testing.assert_array_equal(int8.multiply_by_quantized_multiplier(x, 1 << 30, -2),
                                  np.floor(np.floor(x / 2 + 0.5) / 4 + 0.5))
    assert int8.quantize_multiplier(0.75) == (3 << 29, 0)
    assert int8.quantize_multiplier(0.001) == (int(np.floor(0.001 * 2 ** 40 + 0.5)), -9)


def test_the_benchmarks_tflite_is_the_shipped_artifact():
    assert (ROOT / INT8["tflite"]).read_bytes() == \
        (ROOT / "artifacts/flagship/bundle/model_quantized.tflite").read_bytes()


@pytest.mark.parametrize("mix", [MIX, MIX48], ids=["int16", "f32-48k"])
def test_reference_features_match_the_port(mix):
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.serving import make_ingress
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input

    cfg = ModelConfig.from_dict(BF16)
    (batch,) = small_pool(mix, BF16)
    rate = mix["input_rate"]
    ingress = make_ingress(cfg, rate if rate and rate != cfg.sample_rate else None,
                           mix["input_dtype"])
    port = frontend_input(ingress(torch.as_tensor(batch)), cfg).numpy()
    ref = frontend.features(batch, BF16, mix)
    assert ref.shape == port.shape == (ROWS, 257, 256, 1)
    assert np.abs(ref - port).max() < 2e-5


def test_reference_dscnn_matches_the_port_in_float32():
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    cfg = ModelConfig.from_dict(BF16)
    model = build_dscnn(cfg, class_activation="sigmoid", device="cpu")
    sd = seeded_state(model.state_dict(), BF16, 11, "cpu")
    model.load_state_dict(sd, strict=False)
    feats = torch.from_numpy(frontend.features(small_pool(MIX, BF16)[0], BF16, MIX))
    with torch.no_grad():
        port = model(feats).numpy()
    ref = dscnn.scores(sd, feats, BF16).numpy()
    assert np.abs(ref - port).max() < 1e-5
    assert ref.std() > 0.05  # the seeded scores vary


@pytest.mark.parametrize("config", [INT8, BF16], ids=["int8", "bf16"])
def test_control_fails_the_limit(config):
    pool = small_pool(MIX, config)
    weights = None
    if config["runner"] == "torch":
        from birdnet_stm32_tpu_torch.config import ModelConfig
        from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

        model = build_dscnn(ModelConfig.from_dict(config), class_activation="sigmoid",
                            device="cpu")
        weights = seeded_state(model.state_dict(), config, 11, "cpu")
    ref = correctness.reference_scores(config, MIX, pool, weights, ROOT)
    ctl = correctness.reference_scores(config, MIX, pool, weights, ROOT, control=True)
    numbers = correctness.compare(ctl, [0], ref)
    ok, checks = correctness.verdict(numbers, config["score_gap_limit"])
    assert not ok
    assert checks["score_gap"]["value"] > 2 * config["score_gap_limit"]
