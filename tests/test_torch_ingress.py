"""PyTorch port, the waveform ingress: int16 and mu-law codes dequantized
on the device, and the rest of make_fused_classifier (as_numpy=False, the
classifier cache, make_embedder).

Tolerances:
- ulaw_encode, quantize_waveform_int16 / _ulaw: bit-equal (the same numpy);
- _dequantize_int16: bit-equal to numpy's IEEE division and to the jitted
  JAX function (which divides exactly with _div_exact_int), on every int16
  code against the peak spread of tests/test_int16_exact.py;
- _dequantize_ulaw: within 2e-7 of the jitted JAX decoder on all 256 codes
  (expm1 is not correctly rounded; both multiply by float32 reciprocals);
- int16-ingress scores on raw PCM16 codes: bit-equal to the float-ingress
  scores on the host's peak-normalised floats, on the float leg and on both
  INT8 legs (the dequant rebuilds the same float tensor);
- mu-law scores: the JAX gate against float ingress, score cosine > 0.995
  and |diff| <= 0.1 (tests/test_ulaw_feed.py); against the JAX mu-law
  classifier, 5e-5 (tests/test_torch_serving.py's tolerance between the
  two packages' float legs);
- make_embedder against the JAX one: 1e-4 relative (float32 on both sides,
  summation order differs through the frontend and the DS-CNN).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.data.worker import ulaw_encode as j_ulaw_encode
from birdnet_stm32_tpu.models import serving as J
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu.models.runners import FlaxRunner
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.data.worker import ulaw_encode
from birdnet_stm32_tpu_torch.models import serving as P
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture
from tests.test_torch_cpu_warmup import warm_up

warm_up()

FLAGSHIP_CONFIG = Path(__file__).resolve().parents[1] / "artifacts/flagship/bundle/model_config.json"
SMALL = dict(sample_rate=8000, num_mels=32, spec_width=32, fft_length=256,
             chunk_duration=1.0, embeddings_size=32, num_classes=4,
             class_names=list("abcd"), alpha=0.25, audio_frontend="hybrid",
             mag_scale="pwl", use_se=False, use_inverted_residual=False)
# tests/test_int16_exact.py's peak spread.
PEAKS = np.unique(np.concatenate([np.random.default_rng(7).integers(1, 32769, 40),
                                  [1, 2, 3, 32765, 32767, 32768]]))


@functools.lru_cache(maxsize=None)
def _float_pair():
    """(JAX FlaxRunner, port TorchRunner on the CPU, JAX cfg, port cfg),
    the same weights."""
    jcfg = JaxModelConfig(**SMALL)
    jmodel = j_build_dscnn(jcfg)
    v = jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(0)))
    cfg = ModelConfig(**SMALL)
    model = build_dscnn(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return FlaxRunner(jmodel, v, jcfg), TorchRunner(model, cfg, device="cpu"), jcfg, cfg


@functools.lru_cache(maxsize=None)
def _int8_runners():
    flagship = TFLiteSimRunner(FLAGSHIP_TFLITE, device="cpu")
    return flagship, TFLiteSimRunner(entry_transpose_fixture(flagship.graph), device="cpu")


def _scale_code(peak: int) -> int:
    return peak if peak < 32768 else -32768


def _raw_batch(seed: int, n: int, T: int, peaks):
    """(int16 [n, T+1] raw codes + scale column, the host's float32 [n, T]):
    rows of PCM16 codes whose peak is `peaks[i]`, and the floats
    load_audio_window makes of them, (c / 32768) / (peak / 32768)."""
    rng = np.random.default_rng(seed)
    codes = np.empty((n, T), np.int16)
    for i, pk in enumerate(peaks):
        c = np.clip(np.round(rng.normal(0, pk / 3, T)), -pk, min(pk, 32767)).astype(np.int32)
        c[rng.integers(T)] = -pk if pk == 32768 else pk
        codes[i] = c.astype(np.int16)
    scale = np.array([[_scale_code(pk)] for pk in peaks], np.int16)
    t = codes.astype(np.float32) / np.float32(32768.0)
    floats = t / (np.asarray(peaks, np.float32)[:, None] / np.float32(32768.0))
    return np.concatenate([codes, scale], axis=1), floats


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_ulaw_encode_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 0.5, 20000), rng.uniform(-1.5, 1.5, 5000),
                        [0.0, -0.0, 1.0, -1.0, 1e-9, -1e-9, 2.0, -2.0]]).astype(np.float32)
    got = ulaw_encode(x.copy())
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, j_ulaw_encode(x.copy()))
    w = x[:24000].reshape(4, -1)
    np.testing.assert_array_equal(P.quantize_waveform_ulaw(w), J.quantize_waveform_ulaw(w))


def test_quantize_waveform_int16_bit_equal():
    rng = np.random.default_rng(1)
    w = np.clip(rng.normal(0, 0.6, (3, 4001)), -1.2, 1.2).astype(np.float32)
    got = P.quantize_waveform_int16(w)
    assert got.dtype == np.int16 and got.shape == (3, 4002)
    np.testing.assert_array_equal(got, J.quantize_waveform_int16(w))


def test_dequantize_int16_all_codes():
    """Every int16 code against each peak of the spread: bit-equal to
    numpy's division and to the jitted JAX dequant."""
    codes = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    w = np.empty((PEAKS.size, codes.size + 1), np.int16)
    w[:, :-1] = codes
    w[:, -1] = [_scale_code(int(pk)) for pk in PEAKS]
    got = P._dequantize_int16(torch.from_numpy(w)).numpy()
    want = codes.astype(np.float32)[None] / PEAKS.astype(np.float32)[:, None]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    jgot = np.asarray(jax.jit(J._dequantize_int16)(jnp.asarray(w)))
    np.testing.assert_array_equal(got.view(np.int32), jgot.view(np.int32))


@pytest.mark.parametrize("rows", ["one_row", "zero_scale", "padding_row"])
def test_dequantize_int16_edge_rows(rows):
    """B=1; a scale code of 0 (divides by 1, as max(|0|, 1)); an all-zero
    row, as classify_in_batches pads a ragged tail."""
    rng = np.random.default_rng(2)
    w = rng.integers(-32768, 32768, (3, 257)).astype(np.int16)
    if rows == "one_row":
        w = w[:1]
    elif rows == "zero_scale":
        w[:, -1] = 0
    else:
        w[1:] = 0
    got = P._dequantize_int16(torch.from_numpy(w)).numpy()
    jgot = np.asarray(jax.jit(J._dequantize_int16)(jnp.asarray(w)))
    np.testing.assert_array_equal(got.view(np.int32), jgot.view(np.int32))
    if rows == "padding_row":
        assert not got[1:].any()


def test_dequantize_ulaw_all_codes():
    q = np.arange(-128, 128, dtype=np.int16).astype(np.int8)[None]
    got = P._dequantize_ulaw(torch.from_numpy(q)).numpy()
    ref = np.asarray(jax.jit(J._dequantize_ulaw)(jnp.asarray(q)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-7)
    # The round trip stays within half a companded step (~2.2 % relative).
    x = np.linspace(-1, 1, 4001, dtype=np.float32)[None]
    back = P._dequantize_ulaw(torch.from_numpy(ulaw_encode(x.copy()))).numpy()
    assert np.all(np.abs(back - x) <= 0.023 * np.abs(x) + 1e-4)


def test_int16_scores_bit_equal_float_leg():
    """Raw PCM16 codes through the int16 ingress score exactly as the host's
    floats through the float ingress (float leg, small config); and the
    port's int16 scores stay within 5e-5 of the JAX int16 classifier's."""
    jrunner, runner, jcfg, cfg = _float_pair()
    w16, floats = _raw_batch(3, 4, cfg.chunk_samples, [1200, 32767, 32768, 7])
    f = P.make_fused_classifier(runner, cfg, device="cpu")(floats)
    i = P.make_fused_classifier(runner, cfg, input_dtype="int16", device="cpu")(w16)
    np.testing.assert_array_equal(i, f)
    ref = np.asarray(J.make_fused_classifier(jrunner, jcfg, input_dtype="int16")(w16))
    np.testing.assert_allclose(i, ref, atol=5e-5)


@pytest.mark.parametrize("leg", ["flagship", "fixture"])
def test_int16_scores_bit_equal_int8_legs(leg):
    """The same on the INT8 leg at the flagship geometry: the committed
    graph (entry left unfused) and the entry-transpose fixture (the
    kernel's int8-entry epilogue)."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    runner = dict(zip(("flagship", "fixture"), _int8_runners()))[leg]
    w16, floats = _raw_batch(4, 2, cfg.chunk_samples, [20000, 32768])
    f = P.make_fused_classifier(runner, cfg, device="cpu")
    i = P.make_fused_classifier(runner, cfg, input_dtype="int16", device="cpu")
    assert (f.entry_quant is not None) == (i.entry_quant is not None) == (leg == "fixture")
    np.testing.assert_array_equal(i(w16), f(floats))


def test_ulaw_scores_within_jax_gate():
    jrunner, runner, jcfg, cfg = _float_pair()
    rng = np.random.default_rng(5)
    wave = np.clip(rng.normal(0, 0.1, (4, cfg.chunk_samples)), -0.999, 0.999).astype(np.float32)
    q = P.quantize_waveform_ulaw(wave)
    assert q.dtype == np.int8 and q.shape == wave.shape
    f = P.make_fused_classifier(runner, cfg, device="cpu")(wave)
    u = P.make_fused_classifier(runner, cfg, input_dtype="ulaw", device="cpu")(q)
    assert _cosine(u, f) > 0.995
    np.testing.assert_allclose(u, f, atol=0.1)
    ref = np.asarray(J.make_fused_classifier(jrunner, jcfg, input_dtype="ulaw")(q))
    np.testing.assert_allclose(u, ref, atol=5e-5)


@pytest.mark.parametrize("bad", ["int8", "float16", "pcm"])
def test_invalid_input_dtype(bad):
    _, runner, _, cfg = _float_pair()
    with pytest.raises(ValueError, match="Invalid input_dtype"):
        P.make_fused_classifier(runner, cfg, input_dtype=bad, device="cpu")


def test_as_numpy_false_returns_device_tensor():
    _, runner, _, cfg = _float_pair()
    wave = np.random.default_rng(6).normal(0, 0.3, (2, cfg.chunk_samples)).astype(np.float32)
    t = P.make_fused_classifier(runner, cfg, as_numpy=False, device="cpu")(wave)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), P.make_fused_classifier(runner, cfg, device="cpu")(wave))
    flagship, _ = _int8_runners()
    fcfg = ModelConfig.load(FLAGSHIP_CONFIG)
    s = P.make_fused_classifier(flagship, fcfg, as_numpy=False, device="cpu")(
        np.zeros((1, fcfg.chunk_samples), np.float32))
    assert isinstance(s, torch.Tensor) and s.shape == (1, 100)


def test_classifier_cache_one_per_rate():
    _, runner, _, cfg = _float_pair()
    classifier_for = P.make_classifier_cache(runner, cfg, input_dtype="int16", device="cpu")
    assert classifier_for(8000) is classifier_for(8000)
    assert classifier_for(16000) is not classifier_for(8000)
    rng = np.random.default_rng(7)
    wave = rng.normal(0, 0.2, (2, 16000)).astype(np.float32)
    want = P.make_fused_classifier(runner, cfg, input_sample_rate=16000,
                                   input_dtype="int16", device="cpu")
    q = P.quantize_waveform_int16(wave)
    np.testing.assert_array_equal(classifier_for(16000)(q), want(q))


def test_make_embedder_matches_jax():
    jrunner, runner, jcfg, cfg = _float_pair()
    wave = np.random.default_rng(8).normal(0, 0.3, (3, cfg.chunk_samples)).astype(np.float32)
    got = P.make_embedder(runner, cfg, device="cpu")(wave)
    ref = np.asarray(J.make_embedder(jrunner, jcfg)(wave))
    assert got.shape == ref.shape == (3, runner.model.pred.in_features)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    with pytest.raises(TypeError, match="float"):
        P.make_embedder(_int8_runners()[0], cfg, device="cpu")
