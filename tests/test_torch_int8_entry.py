"""PyTorch port, INT8 leg: the fused int8 entry and the INT8 classifier.

The flagship graph's entry (QUANTIZE -> STRIDED_SLICE -> TRANSPOSE) cannot
be fused, so these tests use the entry-transpose fixture
(tests/int8_fixture.py), which computes the same function with the
reference checkpoint's QUANTIZE -> TRANSPOSE entry. Tolerances:

- the fixture, float or prequantized, and the fused leg against the
  unfused one: bit-equal (the same integer graph on the same codes);
- the plain int8-entry epilogue against the JAX kernel (Pallas interpret
  mode): at most one code apart on fewer than 1 % of codes, the allowance
  of tests/test_pallas.py (the float features differ by ~1e-6, which moves
  a code only next to a rounding tie); against quantize(its own plain float
  features): bit-equal;
- the port's INT8 classify against the JAX make_fused_classifier with the
  same graph: cosine >= 0.999 per row (the framework's conversion gate);
  the scores differ only where a feature code flipped.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models.runners import TFLiteSimRunner as JTFLiteSimRunner
from birdnet_stm32_tpu.models.serving import make_fused_classifier as j_make_fused_classifier
from birdnet_stm32_tpu.ops.pallas.frontend_kernel import fused_spectrogram as j_fused
from birdnet_stm32_tpu.quant import tflite_import as J
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner
from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    frontend_input,
    fused_spectrogram,
    quantize_entry,
)
from birdnet_stm32_tpu_torch.quant import tflite_import as P
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, flagship_features
from tests.test_torch_cpu_warmup import warm_up

warm_up()

FLAGSHIP_CONFIG = Path(__file__).resolve().parents[1] / "artifacts/flagship/bundle/model_config.json"


@functools.lru_cache(maxsize=None)
def _runners():
    """(flagship, fixture) port runners on the CPU."""
    flagship = TFLiteSimRunner(FLAGSHIP_TFLITE, device="cpu")
    return flagship, TFLiteSimRunner(entry_transpose_fixture(flagship.graph), device="cpu")


def _waves(seed: int, n: int, T: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 22050.0
    f0 = rng.uniform(500.0, 6000.0, (n, 1))
    chirp = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.3 * t))
    return (chirp + rng.normal(0, 0.05, (n, T))).astype(np.float32)


def _jax_quantize(x: np.ndarray, scale: float, zp: int) -> np.ndarray:
    return np.asarray(jax.jit(lambda v: jnp.clip(J._round_away(v / scale) + zp, -128, 127)
                              .astype(jnp.int8))(jnp.asarray(x)))


def test_fixture_bit_equal_in_jax():
    """The JAX executor: the fixture graph with float input and with its
    entry prequantized (the jitted quantize) gives the flagship's scores."""
    g = J.TFLiteGraph(str(FLAGSHIP_TFLITE))
    fx = entry_transpose_fixture(g)
    assert J.entry_transpose_perm(g) is None
    assert J.entry_transpose_perm(fx) == (0, 3, 2, 1)
    x = flagship_features(3, seed=1)
    ref = np.asarray(jax.jit(J.build_executor(g, 3))(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jax.jit(J.build_executor(fx, 3))(jnp.asarray(x))),
                                  ref)
    q = _jax_quantize(np.transpose(x, (0, 3, 2, 1)), *J.entry_quant_params(fx))
    pre = jax.jit(J.build_executor(fx, 3, prequantized_input=True))(jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(pre), ref)


def test_fixture_bit_equal_in_port():
    """The same in the port, and with the float input pretransposed; its
    entry quantize equals the jitted JAX one."""
    flagship, fixture = _runners()
    assert P.entry_transpose_perm(flagship.graph) is None
    assert P.entry_transpose_perm(fixture.graph) == (0, 3, 2, 1)
    x = flagship_features(3, seed=1)
    ref = flagship.predict(x)
    np.testing.assert_array_equal(fixture.predict(x), ref)
    scale, zp = P.entry_quant_params(fixture.graph)
    xt = np.transpose(x, (0, 3, 2, 1))
    pt = P.build_executor(fixture.graph, 3, device="cpu", pretransposed_input=True)
    np.testing.assert_array_equal(pt(torch.from_numpy(xt.copy())).numpy(), ref)
    q = P.quantize_f32(torch.from_numpy(xt), P.f32_reciprocal(scale, torch.device("cpu")), zp)
    np.testing.assert_array_equal(q.numpy(), _jax_quantize(xt, scale, zp))
    pre = fixture.executor(3, prequantized_input=True)(q).numpy()
    np.testing.assert_array_equal(pre, ref)


@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "none"), ("mel", "pwl"),
                                      ("mel", "db"), ("mel", "pcen"), ("log_mel", "none"),
                                      ("mfcc", "none")])
def test_plain_int8_epilogue_matches_jax_kernel(mode, mag):
    """fused_spectrogram(quant=...) on a CPU tensor (the plain version) vs
    the JAX kernel's int8 epilogue in interpret mode, at the small geometry
    of tests/test_pallas.py; and bit-equal to quantize(plain float)."""
    y = np.random.default_rng(3).normal(0, 0.5, (3, 8000)).astype(np.float32)
    quant = (0.00392156932502985, -128)
    kw = dict(mode=mode, mag_scale=mag, sample_rate=8000, n_fft=256, mel_bins=32,
              spec_width=32, n_mfcc=13)
    ref = np.asarray(j_fused(jnp.asarray(y), quant=quant, interpret=True, **kw))
    got = fused_spectrogram(torch.from_numpy(y), quant=quant, **kw)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    floats = fused_spectrogram(torch.from_numpy(y), **kw)
    assert torch.equal(got, quantize_entry(floats, quant))


def test_fusion_gate():
    """The fused int8 entry engages for the fixture (QUANTIZE -> TRANSPOSE)
    and not for the flagship, for each kernel-served frontend; never for
    'raw' or a geometry outside the kernel."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    flagship, fixture = _runners()
    assert make_fused_classifier(flagship, cfg, device="cpu").entry_quant is None
    assert make_fused_classifier(fixture, cfg, device="cpu").entry_quant == (
        P.entry_quant_params(fixture.graph))
    for frontend, mag in (("librosa", "pcen"), ("mfcc", "pwl"), ("log_mel", "pwl")):
        c = dataclasses.replace(cfg, audio_frontend=frontend, mag_scale=mag)
        assert make_fused_classifier(fixture, c, device="cpu").entry_quant is not None
    for c in (dataclasses.replace(cfg, audio_frontend="raw"),
              dataclasses.replace(cfg, fft_length=1024)):  # 2 * hop < n_fft
        assert make_fused_classifier(fixture, c, device="cpu").entry_quant is None


def test_int8_classify_is_executor_of_frontend_input():
    """The INT8 classify (port, CPU) is executor(frontend_input(...)) on
    both legs, and the fused leg's scores equal the unfused leg's."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    flagship, fixture = _runners()
    wave = _waves(4, 2, cfg.chunk_samples)
    w = torch.from_numpy(wave)
    before = frontend_kernel.launches.total()
    unfused = make_fused_classifier(flagship, cfg, device="cpu")(wave)
    fused = make_fused_classifier(fixture, cfg, device="cpu")(wave)
    assert frontend_kernel.launches.total() == before  # CPU: plain versions only
    np.testing.assert_array_equal(unfused, flagship.executor(2)(frontend_input(w, cfg)).numpy())
    quant = P.entry_quant_params(fixture.graph)
    entry = frontend_input(w, cfg, quant=quant)
    assert entry.shape == (2, 1, 256, 257) and entry.dtype == torch.int8
    np.testing.assert_array_equal(
        fused, fixture.executor(2, prequantized_input=True)(entry).numpy())
    np.testing.assert_array_equal(fused, unfused)
    assert fused.shape == (2, 100) and 0.0 <= fused.min() and fused.max() <= 1.0


@pytest.mark.parametrize("prequantized", [False, True])
def test_forward_block_picks_the_entry_form(prequantized):
    """On the fixture, TFLiteSimRunner.forward_block takes either entry
    form by its dtype: int8 entry codes go to the prequantized executor,
    float features to the graph's own entry QUANTIZE; bit-equal to each
    executor. The runner's entry_quant is the graph's, None on the
    flagship."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    flagship, fixture = _runners()
    assert flagship.entry_quant is None
    assert fixture.entry_quant == P.entry_quant_params(fixture.graph)
    w = torch.from_numpy(_waves(6, 2, cfg.chunk_samples))
    x = frontend_input(w, cfg, quant=fixture.entry_quant if prequantized else None)
    assert (x.dtype == torch.int8) == prequantized
    want = fixture.executor(2, prequantized_input=prequantized)(x).numpy()
    np.testing.assert_array_equal(fixture.forward_block(x).numpy(), want)


def test_int8_classify_matches_jax():
    """Port INT8 classify (fused leg, CPU) vs the JAX make_fused_classifier
    over its TFLiteSimRunner with the same fixture graph: cosine >= 0.999
    per row."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    wave = _waves(5, 2, cfg.chunk_samples)
    runner = JTFLiteSimRunner(str(FLAGSHIP_TFLITE))
    runner.graph = entry_transpose_fixture(runner.graph)
    ref = np.asarray(j_make_fused_classifier(runner, JaxModelConfig.load(FLAGSHIP_CONFIG))(wave))
    got = make_fused_classifier(_runners()[1], cfg, device="cpu")(wave)
    assert got.shape == ref.shape == (2, 100)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.999, cos


def test_int8_entry_points_default_to_cuda():
    """Without device=, the INT8 entry points run on CUDA; on a machine
    without it they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFLiteSimRunner(FLAGSHIP_TFLITE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_executor(_runners()[0].graph, 1)
