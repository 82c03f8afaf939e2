"""PyTorch port, the fused frontend's epilogues against the JAX package.

Every (mode, mag_scale) of the fused frontend goes through the port's
`fused_spectrogram` on a CPU tensor (the kernels' plain version) and is held
against the JAX kernel in Pallas interpret mode and against the JAX
composition `spectrogram_batch`, atol 2e-5 on [0, 1]-normalized features:
the gate tests/test_pallas.py holds the JAX kernel to. Both sides compute
in float32 and differ in summation order, and pcen's smoother runs
sequentially here where the JAX package runs an associative scan.
Inputs are made with numpy from a seed and fed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.ops import magnitude as jmag
from birdnet_stm32_tpu.ops.dct import dct_matrix as j_dct_matrix
from birdnet_stm32_tpu.ops.pallas.frontend_kernel import frontend_input as j_frontend_input
from birdnet_stm32_tpu.ops.pallas.frontend_kernel import fused_spectrogram as j_fused
from birdnet_stm32_tpu.ops.spectrogram import spectrogram_batch as j_spectrogram_batch
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.ops import magnitude as tmag
from birdnet_stm32_tpu_torch.ops.dct import dct2_ortho, dct_matrix
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    frontend_input,
    fused_spectrogram,
    fused_spectrogram_plain,
    kernel_name,
)
from tests.test_torch_cpu_warmup import warm_up

warm_up()

# tests/test_pallas.py:107-115, every combo the export matrix produces.
EPILOGUE_COMBOS = [
    ("linear", "none"),
    ("mel", "none"),
    ("mel", "pwl"),
    ("mel", "pcen"),
    ("mel", "db"),
    ("log_mel", "none"),
    ("mfcc", "none"),
]
# The linear mode with a magnitude scale: the JAX kernel computes it too.
LINEAR_SCALED = [("linear", "pwl"), ("linear", "db"), ("linear", "pcen")]
# The small geometry of tests/test_pallas.py:124-125.
SMALL = dict(sample_rate=8000, n_fft=256, mel_bins=32, spec_width=32, n_mfcc=13)
FLAGSHIP = dict(sample_rate=22050, n_fft=512, mel_bins=64, spec_width=256, n_mfcc=20)


def _wave(seed, B, T):
    return np.random.default_rng(seed).normal(0, 0.5, (B, T)).astype(np.float32)


def _port(y, mode, mag, geometry):
    return fused_spectrogram(torch.from_numpy(y), mode=mode, mag_scale=mag, **geometry).numpy()


@pytest.mark.parametrize("reference", ["jax_kernel", "jax_composition"])
@pytest.mark.parametrize("mode,mag", EPILOGUE_COMBOS + LINEAR_SCALED)
def test_fused_epilogue_matches_jax(mode, mag, reference):
    y = _wave(0, 8, 8000)
    if reference == "jax_kernel":
        ref = j_fused(jnp.asarray(y), mode=mode, mag_scale=mag, interpret=True, **SMALL)
    else:
        ref = j_spectrogram_batch(
            jnp.asarray(y), sample_rate=8000, n_fft=256,
            mel_bins=-1 if mode == "linear" else 32, spec_width=32, mag_scale=mag,
            mode=mode, n_mfcc=13)
    ref = np.asarray(ref)
    got = _port(y, mode, mag, SMALL)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("mode,mag", [("mel", "pwl"), ("mfcc", "none")])
def test_fused_epilogue_matches_jax_at_flagship_geometry(mode, mag):
    """B=2, T=66150, n_fft 512, hop 258, 64 mels: mfcc computes 257 frames
    and keeps 256 after the DCT."""
    y = _wave(1, 2, 66150)
    ref = np.asarray(j_fused(jnp.asarray(y), mode=mode, mag_scale=mag, interpret=True,
                             **FLAGSHIP))
    got = _port(y, mode, mag, FLAGSHIP)
    assert got.shape == ref.shape == (2, 20 if mode == "mfcc" else 64, 256)
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("frontend,mag", [("hybrid", "pwl"), ("librosa", "none"),
                                          ("librosa", "pwl"), ("librosa", "db"),
                                          ("librosa", "pcen"), ("log_mel", "pwl"),
                                          ("mfcc", "pwl")])
def test_frontend_input_matches_jax(frontend, mag):
    """The dispatch: mag_scale reaches the kernel only in mode 'mel', and
    pcen goes through the fused path (the JAX dispatch in interpret mode
    runs its kernel for pcen too)."""
    kw = dict(sample_rate=8000, num_mels=32, spec_width=32, fft_length=256,
              chunk_duration=1.0, n_mfcc=13, num_classes=2, class_names=["a", "b"],
              audio_frontend=frontend, mag_scale=mag)
    y = _wave(5, 3, 8000)
    ref = np.asarray(j_frontend_input(jnp.asarray(y), JaxModelConfig(**kw), interpret=True))
    got = frontend_input(torch.from_numpy(y), ModelConfig(**kw)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("n_in,n_out", [(64, 20), (32, 13), (40, 40), (7, 3)])
def test_dct_matrix_bit_equal_to_jax(n_in, n_out):
    np.testing.assert_array_equal(dct_matrix(n_in, n_out), j_dct_matrix(n_in, n_out))


def test_dct2_ortho_matches_scipy_definition():
    """Row 0 scaled by sqrt(1/(4N)), the rest by sqrt(1/(2N)): an
    orthonormal basis when n_out == n_in."""
    d = dct_matrix(16, 16).astype(np.float64)
    np.testing.assert_allclose(d.T @ d, np.eye(16), atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32))
    np.testing.assert_allclose(dct2_ortho(x, 5).numpy(), x.numpy() @ dct_matrix(16, 5),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sr,hop,frames", [(8000, 250, 33), (22050, 258, 256), (16000, 128, 7)])
def test_pcen_matches_jax(sr, hop, frames):
    """The sequential smoother against the JAX associative scan, on the
    2^31-scaled magnitudes the frontend feeds it; atol 1e-5 after the
    per-sample min-max the frontend applies next."""
    S = np.random.default_rng(sr + hop).gamma(0.5, 0.2, (2, 16, frames)).astype(np.float32)
    S = S * np.float32(2.0**31)
    got = tmag.normalize_minmax(tmag.pcen(torch.from_numpy(S), sr=sr, hop_length=hop),
                                dim=(1, 2)).numpy()
    ref = np.asarray(jmag.normalize_minmax(jmag.pcen(jnp.asarray(S), sr=sr, hop_length=hop),
                                           axis=(1, 2)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_pcen_starts_at_first_frame():
    """m[0] = S[0] (lfilter_zi): a constant input gives a constant output."""
    S = torch.full((1, 3, 10), 5.0e8)
    out = tmag.pcen(S, sr=22050, hop_length=258)
    torch.testing.assert_close(out, out[..., :1].expand_as(out), rtol=0, atol=0)


@pytest.mark.parametrize("mode,mag", EPILOGUE_COMBOS + LINEAR_SCALED)
def test_plain_version_is_the_cpu_path(mode, mag):
    """On a CPU tensor the wrapper runs its plain version and counts no
    launch; mfcc's plain version keeps out_w of its 33 frames."""
    y = _wave(3, 2, 8000)
    before = frontend_kernel.launches.total()
    got = _port(y, mode, mag, SMALL)
    n_frames = 33 if mode == "mfcc" else 32
    plain = fused_spectrogram_plain(torch.from_numpy(y), 256, 250, n_frames, mode=mode,
                                    mag_scale=mag, sample_rate=8000, mel_bins=32,
                                    n_mfcc=13, out_w=32).numpy()
    np.testing.assert_array_equal(got, plain)
    assert frontend_kernel.launches.total() == before


def test_kernel_names():
    assert kernel_name("linear", "none") == "fused_spectrogram_linear"
    assert kernel_name("mel", "pwl") == "fused_spectrogram_mel_pwl"
    assert kernel_name("log_mel", "db") == "fused_spectrogram_log_mel"
    assert kernel_name("mfcc", "pcen") == "fused_spectrogram_mfcc"


@pytest.mark.parametrize("kw,match", [(dict(mode="cqt"), "mode"),
                                      (dict(mag_scale="log"), "mag_scale"),
                                      (dict(mode="mel", mel_bins=0), "mel_bins")])
def test_wrapper_rejects_bad_epilogue(kw, match):
    with pytest.raises(ValueError, match=match):
        fused_spectrogram(torch.zeros(2, 8000), n_fft=256, spec_width=32, **kw)
