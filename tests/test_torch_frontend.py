"""PyTorch port, frontend: each ported module against its JAX counterpart.

Inputs are made with numpy from a seed and fed to both packages. The JAX
fused kernel runs in Pallas interpret mode, as tests/test_pallas.py runs it
on the CPU. Tolerances: atol 1e-5 on [0, 1]-normalized features — both
sides compute in float32 (the JAX side at HIGHEST precision) and differ
only in summation order (measured ~7e-7 at the flagship geometry).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.ops import magnitude as jmag
from birdnet_stm32_tpu.ops.frontend import inputs_for_config as j_inputs_for_config
from birdnet_stm32_tpu.ops.mel import mel_filterbank as j_mel_filterbank
from birdnet_stm32_tpu.ops.pallas.frontend_kernel import fused_spectrogram as j_fused
from birdnet_stm32_tpu.ops.spectrogram import spectrogram_batch as j_spectrogram_batch
from birdnet_stm32_tpu.ops.stft import dft_bases as j_dft_bases
from birdnet_stm32_tpu.ops.stft import stft_magnitude as j_stft_magnitude
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.ops import magnitude as tmag
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    frontend_input,
    fused_hybrid_frontend,
    fused_spectrogram,
    hybrid_frontend_input,
)
from birdnet_stm32_tpu_torch.ops.mel import mel_filterbank
from birdnet_stm32_tpu_torch.ops.spectrogram import spectrogram_batch
from birdnet_stm32_tpu_torch.ops.stft import dft_bases, stft_magnitude
from tests.test_torch_cpu_warmup import warm_up

warm_up()

FLAGSHIP_CONFIG = "artifacts/flagship/bundle/model_config.json"

# (B, T, n_fft, spec_width): the flagship serving geometry (hop 258, 256
# frames) and a small one (hop 250, 32 frames).
GEOMETRIES = {"flagship": (2, 66150, 512, 256), "small": (3, 8000, 256, 32)}


def _small_cfg(cls, **kw):
    base = dict(sample_rate=8000, num_mels=32, spec_width=32, fft_length=256,
                chunk_duration=1.0, embeddings_size=32, num_classes=2,
                class_names=["a", "b"], audio_frontend="hybrid", mag_scale="pwl")
    base.update(kw)
    return cls(**base)


def _wave(seed, B, T):
    return np.random.default_rng(seed).normal(0, 0.5, (B, T)).astype(np.float32)


def test_config_matches_jax():
    """The port's own ModelConfig copy loads the flagship sidecar exactly
    as the JAX one does, derived geometry included; the port's names its
    architecture besides, the DS-CNN where the sidecar names none."""
    t, j = ModelConfig.load(FLAGSHIP_CONFIG), JaxModelConfig.load(FLAGSHIP_CONFIG)
    assert t.to_dict() == {**j.to_dict(), "architecture": "dscnn"}
    assert (t.chunk_samples, t.compute_hop_length(), t.fft_bins, t.input_shape()) == (
        j.chunk_samples, j.compute_hop_length(), j.fft_bins, j.input_shape())
    assert (t.chunk_samples, t.hop_length, t.input_shape()) == (66150, 258, (257, 256, 1))


def test_constants_match_jax():
    """Mel filterbank and windowed DFT bases are the same float32 constants."""
    np.testing.assert_array_equal(mel_filterbank(22050, 512, 64, fmin=150.0, fmax=11025.0),
                                  j_mel_filterbank(22050, 512, 64, fmin=150.0, fmax=11025.0))
    for a, b in zip(dft_bases(512), j_dft_bases(512)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_fused_spectrogram_matches_jax_kernel(geometry):
    """The port's kernel wrapper on a CPU tensor (its plain version) vs the
    JAX Pallas kernel in interpret mode, mode='linear' (the hybrid frontend)."""
    B, T, n_fft, W = GEOMETRIES[geometry]
    y = _wave(0, B, T)
    ref = np.asarray(j_fused(jnp.asarray(y), mode="linear", n_fft=n_fft, spec_width=W,
                             interpret=True))
    got = fused_spectrogram(torch.from_numpy(y), n_fft=n_fft, spec_width=W).numpy()
    assert got.shape == ref.shape == (B, n_fft // 2 + 1, W)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_fused_spectrogram_matches_jax_composition(geometry):
    B, T, n_fft, W = GEOMETRIES[geometry]
    y = _wave(1, B, T)
    ref = np.asarray(j_spectrogram_batch(jnp.asarray(y), n_fft=n_fft, mel_bins=-1,
                                         spec_width=W, mode="linear"))
    got = fused_spectrogram(torch.from_numpy(y), n_fft=n_fft, spec_width=W).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("linear", "pwl"),
                                      ("linear", "db"), ("linear", "pcen"), ("mel", "none"),
                                      ("mel", "pwl"), ("mel", "db"), ("mel", "pcen"),
                                      ("log_mel", "none"), ("mfcc", "none")])
def test_spectrogram_batch_matches_jax(mode, mag):
    y = _wave(2, 3, 8000)
    kw = dict(sample_rate=8000, n_fft=256, mel_bins=(-1 if mode == "linear" else 32),
              spec_width=32, mag_scale=mag, mode=mode, n_mfcc=13)
    ref = np.asarray(j_spectrogram_batch(jnp.asarray(y), **kw))
    got = spectrogram_batch(torch.from_numpy(y), **kw).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("hop,n_frames", [(128, 40), (64, 60), (300, 20)])
def test_stft_magnitude_matches_jax(hop, n_frames):
    """Window-2 framing (2*hop >= n_fft), the gather fallback (2*hop <
    n_fft) and hop > n_fft. Raw magnitudes: atol relative to their scale."""
    y = _wave(3, 2, 6000)
    ref = np.asarray(j_stft_magnitude(jnp.asarray(y), n_fft=256, hop=hop, n_frames=n_frames))
    got = stft_magnitude(torch.from_numpy(y), n_fft=256, hop=hop, n_frames=n_frames).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * float(np.abs(ref).max()))


def test_magnitude_ops_match_jax():
    S = np.random.default_rng(4).uniform(0, 3, (2, 16, 12)).astype(np.float32)
    t, j, dims = torch.from_numpy(S), jnp.asarray(S), (1, 2)
    pairs = [
        (tmag.normalize_minmax(t, dim=dims), jmag.normalize_minmax(j, axis=dims)),
        (tmag.normalize_minmax(t), jmag.normalize_minmax(j)),
        (tmag.pwl_compress(t), jmag.pwl_compress(j)),
        (tmag.power_to_db(t, ref=t.amax(dim=dims, keepdim=True), dim=dims),
         jmag.power_to_db(j, ref=j.max(axis=dims, keepdims=True), axis=dims)),
        (tmag.amplitude_to_db(t, ref=2.0, dim=dims), jmag.amplitude_to_db(j, ref=2.0, axis=dims)),
        (tmag.db_compress(t), jmag.db_compress(j)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("frontend", ["hybrid", "librosa", "raw", "log_mel", "mfcc"])
def test_inputs_for_config_matches_jax(frontend):
    kw = dict(audio_frontend=frontend, mag_scale="none" if frontend == "raw" else "pwl")
    cfg, jcfg = _small_cfg(ModelConfig, **kw), _small_cfg(JaxModelConfig, **kw)
    y = _wave(5, 3, cfg.chunk_samples)
    ref = np.asarray(j_inputs_for_config(jnp.asarray(y), jcfg))
    got = inputs_for_config(torch.from_numpy(y), cfg).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_frontend_input_small_hop_takes_composition():
    """2*hop < n_fft is outside the kernel's precondition: the dispatch
    takes the composition, as the JAX dispatch does, and no kernel runs."""
    cfg = ModelConfig(sample_rate=4000, num_mels=16, spec_width=256, fft_length=128,
                      chunk_duration=1.0, num_classes=2, class_names=["a", "b"],
                      audio_frontend="hybrid", mag_scale="pwl")  # hop 15
    y = _wave(6, 2, 4000)
    before = frontend_kernel.launches.total()
    got = frontend_input(torch.from_numpy(y), cfg).numpy()
    ref = np.asarray(j_spectrogram_batch(jnp.asarray(y), sample_rate=4000, n_fft=128,
                                         mel_bins=-1, spec_width=256, mode="linear"))[..., None]
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(hybrid_frontend_input(torch.from_numpy(y), cfg).numpy(),
                               ref, atol=1e-5)
    assert frontend_kernel.launches.total() == before
    with pytest.raises(ValueError, match="2\\*hop"):
        fused_spectrogram(torch.from_numpy(y), n_fft=128, spec_width=256)


def test_frontend_input_hybrid_uses_fused_path():
    cfg = _small_cfg(ModelConfig)
    y = _wave(7, 2, cfg.chunk_samples)
    got = frontend_input(torch.from_numpy(y), cfg)
    assert got.shape == (2, cfg.fft_bins, cfg.spec_width, 1)
    explicit = fused_hybrid_frontend(torch.from_numpy(y), 256, 250, 32)
    torch.testing.assert_close(got[..., 0], explicit, rtol=0, atol=0)


def test_cpu_tensor_never_counts_a_launch():
    y = torch.from_numpy(_wave(8, 2, 8000))
    before = frontend_kernel.launches.total()
    fused_spectrogram(y, n_fft=256, spec_width=32)
    for frontend in ("hybrid", "librosa", "log_mel", "mfcc"):
        frontend_input(y, _small_cfg(ModelConfig, audio_frontend=frontend))
    assert frontend_kernel.launches.total() == before


@pytest.mark.parametrize("kw", [dict(mode="bogus"), dict(mag_scale="bogus"),
                                dict(mode="mel", mel_bins=0)])
def test_unported_epilogues_raise(kw):
    """Every epilogue of the kernel is ported, the int8 entry included; a
    mode, mag_scale or mel count it does not have raises ValueError."""
    with pytest.raises(ValueError):
        fused_spectrogram(torch.zeros(2, 8000), n_fft=256, spec_width=32,
                          quant=(1.0 / 255.0, -128), **kw)


def test_unported_frontends_raise():
    """The composition frontends (raw, or 2*hop < n_fft) have no int8-entry
    epilogue: asking frontend_input for the executor's entry tensor there
    raises ValueError, as in the JAX dispatch."""
    y = torch.zeros(2, 8000)
    with pytest.raises(ValueError, match="no composition fallback"):
        frontend_input(y, _small_cfg(ModelConfig, audio_frontend="raw"),
                       quant=(1.0 / 255.0, -128))
    with pytest.raises(ValueError, match="no composition fallback"):
        frontend_input(y, _small_cfg(ModelConfig, fft_length=1024), quant=(1.0 / 255.0, -128))


@pytest.mark.parametrize("frontend", ["hybrid", "librosa", "mfcc", "log_mel"])
def test_frontend_input_int8_entry(frontend):
    """frontend_input(quant=...) serves the int8 entry tensor [B, 1, W, bins]
    for every kernel frontend: the executor's quantize of the float features,
    transposed, bit for bit."""
    cfg = _small_cfg(ModelConfig, audio_frontend=frontend)
    y = torch.from_numpy(_wave(9, 2, cfg.chunk_samples))
    quant = (1.0 / 255.0, -128)
    got = frontend_input(y, cfg, quant=quant)
    floats = frontend_input(y, cfg)[..., 0]  # [B, bins, W]
    assert got.dtype == torch.int8 and got.shape == (2, 1, floats.shape[2], floats.shape[1])
    v = (floats.transpose(1, 2).numpy() * (np.float32(1) / np.float32(quant[0])))
    manual = np.clip(np.sign(v) * np.floor(np.abs(v) + np.float32(0.5)) + quant[1], -128, 127)
    np.testing.assert_array_equal(got[:, 0].numpy(), manual.astype(np.int8))


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match="float32"):
        fused_spectrogram(torch.zeros(2, 8000, dtype=torch.float64), n_fft=256, spec_width=32)
    with pytest.raises(ValueError, match="float32"):
        fused_spectrogram(torch.zeros(8000), n_fft=256, spec_width=32)
