"""PyTorch port, the on-device polyphase resampler (ops/resample.py) and
serving with input_sample_rate.

Tolerances:
- kaiser_poly_filter: 1e-6 against the JAX one (the same scipy firwin,
  float32);
- resample_poly_device and resample_chunk_batch: atol 2e-5 / rtol 1e-4
  against scipy.signal.resample_poly in float64 and against the JAX
  function (tests/test_resample.py's gate: float32 convolutions over up to
  6401 taps, summed in another order);
- a classifier fed at the source rate against the same classifier fed the
  host-resampled batch: atol 1e-5 / rtol 1e-4 (tests/test_resample.py).
"""

from math import gcd

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.ops import resample as J
from birdnet_stm32_tpu_torch.audio.io import fast_resample
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
from birdnet_stm32_tpu_torch.models.runners import TorchRunner
from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
from birdnet_stm32_tpu_torch.ops import resample as P
from tests.test_torch_cpu_warmup import warm_up

warm_up()

RATE_PAIRS = [(8000, 4000), (44100, 22050), (48000, 22050), (16000, 22050)]


def _up_down(sr_in, sr_out):
    g = gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


@pytest.mark.parametrize("up,down", [(1, 2), (3, 4), (147, 320), (441, 320), (2, 1)])
def test_filter_matches_jax(up, down):
    got = P.kaiser_poly_filter(up, down)
    assert got.dtype == np.float32 and got.shape == (2 * 10 * max(up, down) + 1,)
    np.testing.assert_allclose(got, J.kaiser_poly_filter(up, down), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sr_in,sr_out", RATE_PAIRS)
@pytest.mark.parametrize("exact", [True, False], ids=["len_exact", "len_rounds_up"])
def test_resample_matches_scipy_and_jax(sr_in, sr_out, exact):
    """Lengths where T * up / down is a whole number, and where it rounds up."""
    up, down = _up_down(sr_in, sr_out)
    T = down * (4800 // down) if exact else 4801
    assert ((T * up) % down == 0) == exact
    x = np.random.default_rng(0).normal(size=(3, T)).astype(np.float32)
    got = P.resample_poly_device(torch.from_numpy(x), sr_in, sr_out).numpy()
    want = resample_poly(x.astype(np.float64), up, down, axis=-1)
    assert got.shape == want.shape
    assert got.shape[-1] == P.resample_output_len(T, sr_in, sr_out)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(J.resample_poly_device(x, sr_in, sr_out)),
                               atol=2e-5, rtol=1e-4)


def test_identity_and_1d():
    x = np.random.default_rng(1).normal(size=513).astype(np.float32)
    same = P.resample_poly_device(torch.from_numpy(x), 24000, 24000).numpy()
    np.testing.assert_array_equal(same, x)
    y = P.resample_poly_device(torch.from_numpy(x), 44100, 22050).numpy()
    assert y.ndim == 1
    np.testing.assert_allclose(y, resample_poly(x, 1, 2), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("sr_in", [16000, 48000, 44100])
@pytest.mark.parametrize("delta", [-3, 0, 3], ids=["short", "exact", "long"])
def test_resample_chunk_batch_matches_jax(sr_in, delta):
    """Pads or trims to cfg.chunk_samples, as the JAX function does."""
    kw = dict(sample_rate=22050, num_mels=32, spec_width=32, fft_length=256, chunk_duration=0.4)
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    T = int(cfg.chunk_duration * sr_in) + delta
    x = np.random.default_rng(2).normal(0, 0.3, (2, T)).astype(np.float32)
    got = P.resample_chunk_batch(torch.from_numpy(x), sr_in, cfg).numpy()
    ref = np.asarray(J.resample_chunk_batch(x, sr_in, jcfg))
    assert got.shape == ref.shape == (2, cfg.chunk_samples)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("input_dtype", [None, "int16"])
def test_serving_with_input_sample_rate_matches_host_resample(input_dtype):
    """classify(native-rate batch) == classify(host-resampled batch), and
    with int16 ingress the dequant runs before the resampler."""
    cfg = ModelConfig(sample_rate=4000, num_mels=16, spec_width=32, fft_length=128,
                      chunk_duration=1.0, embeddings_size=32, num_classes=3,
                      audio_frontend="hybrid", mag_scale="pwl", alpha=0.25)
    runner = TorchRunner(init_model(build_dscnn(cfg, device="cpu"), seed=0), cfg, device="cpu")
    sr_src = 8000
    wave = np.random.default_rng(4).normal(0, 0.3, (2, sr_src)).astype(np.float32)
    wave /= np.abs(wave).max()
    if input_dtype == "int16":
        codes = np.round(wave * 32767.0).astype(np.int16)
        src = np.concatenate([codes, np.full((2, 1), 32767, np.int16)], axis=1)
        wave = codes.astype(np.float32) / np.float32(32767.0)
    else:
        src = wave
    native = make_fused_classifier(runner, cfg, input_sample_rate=sr_src,
                                   input_dtype=input_dtype, device="cpu")
    host = make_fused_classifier(runner, cfg, device="cpu")
    wave_host = np.stack([fast_resample(w, sr_src, cfg.sample_rate)
                          for w in wave])[:, :cfg.chunk_samples]
    np.testing.assert_allclose(native(src), host(wave_host), atol=1e-5, rtol=1e-4)
