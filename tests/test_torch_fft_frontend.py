"""PyTorch port, the host side of the fused frontend kernels' in-block FFT.

The CUDA kernels (ops/csrc/frontend_kernel.cu) compute the windowed real DFT
as a per-frame real FFT, from two host tables held here against their
definitions and the JAX package:

- `fft_table(n_fft)`: twiddles W^m = exp(-2 pi i m / n_fft), m < n_fft,
  built in float64 and rounded once (within 0.5 ulp), then the float32
  periodic Hann window, bit-equal to `hann_window` in both packages;
- `mel_ranges(...)`: the Slaney mel bank as each mel's nonzero bin range
  and weights, which rebuild the dense `mel_filterbank` exactly.

The kernels take n_fft as a power of two from 64 to 2048: `_check_launch`
and `_kernel_geometry_ok` say so, and `frontend_input` serves any other
n_fft through the composition, matching the JAX `inputs_for_config`.

The tolerance budget the FFT route relies on: a float32 FFT (here
`torch.fft.rfft`, a stand-in for the kernel's stage; the port itself never
calls it) of the Hann-windowed frames, through the port's
`spectrogram_epilogue`, stays within the card tests' tolerances of
`fused_spectrogram_plain` (the DFT-as-matmul plain version): 1e-5 linear,
2e-5 the other epilogues, 1e-4 linear + dB, and int8 codes at most one
apart on fewer than 1 %, for every specialisation at the flagship geometry.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.ops.frontend import inputs_for_config as j_inputs_for_config
from birdnet_stm32_tpu.ops.mel import mel_filterbank as j_mel_filterbank
from birdnet_stm32_tpu.ops.stft import hann_window as j_hann_window
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    _check_launch,
    _kernel_geometry_ok,
    fft_size_ok,
    fft_table,
    frontend_input,
    fused_spectrogram_plain,
    mel_ranges,
    quantize_entry,
)
from birdnet_stm32_tpu_torch.ops.kernels import _build
from birdnet_stm32_tpu_torch.ops.mel import mel_filterbank
from birdnet_stm32_tpu_torch.ops.spectrogram import spectrogram_epilogue
from birdnet_stm32_tpu_torch.scripts.kernel_variants import no_tail_source
from birdnet_stm32_tpu_torch.ops.stft import hann_window
from tests.test_torch_cpu_warmup import warm_up

warm_up()

FFT_SIZES = [64, 128, 256, 512, 1024, 2048]
NOT_FFT_SIZES = [384, 96, 4096]
FLAGSHIP_CONFIG = "artifacts/flagship/bundle/model_config.json"
# Every specialisation of the kernels: (mode, mag_scale, int8 entry).
SPECS = [("linear", "none", False), ("mel", "none", False), ("mel", "pwl", False),
         ("mel", "db", False), ("mel", "pcen", False), ("log_mel", "none", False),
         ("mfcc", "none", False), ("linear", "pwl", False), ("linear", "db", False),
         ("linear", "pcen", False), ("linear", "none", True), ("mel", "pwl", True)]
TOLERANCE = {("linear", "none"): 1e-5, ("linear", "db"): 1e-4}
QUANT = (0.00392156932502985, -128)


@pytest.mark.parametrize("n_fft", FFT_SIZES)
def test_fft_table_twiddles_and_window(n_fft):
    """Twiddles are float64 cos/sin rounded once (within 0.5 ulp); the
    window is hann_window(n_fft) of both packages, bit for bit."""
    table = fft_table(n_fft)
    assert table.dtype == np.float32 and table.shape == (3 * n_fft,)
    tw = table[: 2 * n_fft].reshape(n_fft, 2).astype(np.float64)
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    exact = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    np.testing.assert_array_equal(tw, exact.astype(np.float32))
    half_ulp = 0.5 * np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (np.abs(tw - exact) <= half_ulp).all()
    window = table[2 * n_fft:]
    assert window.tobytes() == hann_window(n_fft).tobytes()
    assert window.tobytes() == np.asarray(j_hann_window(n_fft), dtype=np.float32).tobytes()


@pytest.mark.parametrize("n_fft", [256, 512])
@pytest.mark.parametrize("n_mels", [32, 64, 128])
@pytest.mark.parametrize("sample_rate", [22050, 16000])
def test_mel_ranges_rebuild_dense_bank(sample_rate, n_fft, n_mels):
    """Each mel's [lo, hi) spans exactly its nonzero bins, and the compact
    weights rebuild the dense bank of both packages exactly."""
    ranges, weights = mel_ranges(sample_rate, n_fft, n_mels)
    dense = mel_filterbank(sample_rate, n_fft, n_mels, fmin=150.0, fmax=float(sample_rate // 2))
    j_dense = np.asarray(j_mel_filterbank(sample_rate, n_fft, n_mels, fmin=150.0,
                                          fmax=float(sample_rate // 2)))
    assert ranges.shape == (n_mels, 4) and ranges.dtype == np.int32
    assert weights.dtype == np.float32 and weights.size == np.count_nonzero(dense)
    rebuilt = np.zeros_like(dense)
    for m, (lo, hi, base, _) in enumerate(ranges):
        nz = np.flatnonzero(dense[:, m])
        assert (lo, hi) == ((nz[0], nz[-1] + 1) if nz.size else (0, 0))
        rebuilt[lo:hi, m] = weights[base + lo: base + hi]
    assert rebuilt.tobytes() == dense.tobytes()
    assert rebuilt.tobytes() == j_dense.astype(np.float32).tobytes()


def test_flagship_mel_bank_nonzeros():
    """The flagship's 64-mel bank at n_fft 512 has 491 nonzero weights: the
    mel product's multiply-adds per frame."""
    assert mel_ranges(22050, 512, 64)[1].size == 491


@pytest.mark.parametrize("n_fft", FFT_SIZES + NOT_FFT_SIZES)
def test_fft_size_gate(n_fft):
    """Powers of two in 64..2048 pass the launch check and the geometry
    gate; 384, 96 and 4096 do not (hop large enough in both cases)."""
    ok = n_fft in FFT_SIZES
    assert fft_size_ok(n_fft) == ok
    flagship = ModelConfig.load(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(flagship, fft_length=n_fft, spec_width=16,
                              hop_length=flagship.chunk_samples // 16)
    assert 2 * (cfg.chunk_samples // cfg.spec_width) >= n_fft
    assert _kernel_geometry_ok(cfg, cfg.chunk_samples) == ok
    y = torch.zeros(2, 8000)
    if ok:
        _check_launch(y, n_fft, 1)
    else:
        with pytest.raises(ValueError, match="power of two in 64..2048"):
            _check_launch(y, n_fft, 1)


@pytest.mark.parametrize("frontend", ["hybrid", "librosa", "log_mel", "mfcc"])
@pytest.mark.parametrize("n_fft", [384, 96])
def test_frontend_input_routes_other_fft_sizes_to_composition(monkeypatch, frontend, n_fft):
    """An n_fft the FFT does not take goes to the composition (the kernel
    wrapper is never called) and matches the JAX inputs_for_config; asking
    for the int8 entry there raises, as for any composition config."""
    kw = dict(sample_rate=8000, num_mels=16, spec_width=32, fft_length=n_fft,
              chunk_duration=1.0, num_classes=2, class_names=["a", "b"],
              audio_frontend=frontend, mag_scale="pwl")
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    y = np.random.default_rng(3).normal(0, 0.5, (2, cfg.chunk_samples)).astype(np.float32)

    def no_kernel(*args, **kwargs):
        raise AssertionError("fused_spectrogram called for a composition config")

    monkeypatch.setattr(frontend_kernel, "fused_spectrogram", no_kernel)
    got = frontend_input(torch.from_numpy(y), cfg).numpy()
    ref = np.asarray(j_inputs_for_config(jnp.asarray(y), jcfg))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    with pytest.raises(ValueError, match="no composition fallback"):
        frontend_input(torch.from_numpy(y), cfg, quant=QUANT)


def _fft_stand_in(y: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """[B, T] -> [B, n_frames, F]: |float32 rfft| of the centre-padded,
    Hann-windowed frames, the function the kernels' FFT stage computes."""
    ypad = F.pad(y, (n_fft // 2, n_fft // 2 + (n_frames + 1) * hop))
    frames = ypad.unfold(1, n_fft, hop)[:, :n_frames]
    return torch.fft.rfft(frames * torch.from_numpy(hann_window(n_fft))).abs()


@pytest.mark.parametrize("mode,mag,int8", SPECS)
def test_fft_route_within_card_tolerances(mode, mag, int8):
    """The FFT route's rounding at the flagship geometry, every
    specialisation: within the card tests' tolerance of the plain version
    (the DFT as a float32 matrix product)."""
    sr, n_fft, T, spec_width, mels, n_mfcc = 22050, 512, 66150, 256, 64, 20
    hop = T // spec_width
    n_frames = 1 + T // hop if mode == "mfcc" else spec_width
    y = torch.from_numpy(np.random.default_rng(11).normal(0, 0.5, (4, T)).astype(np.float32))
    S = _fft_stand_in(y, n_fft, hop, n_frames)
    got = spectrogram_epilogue(S, mode, mag, sr, n_fft, hop, -1 if mode == "linear" else mels,
                               n_mfcc, spec_width)
    ref = fused_spectrogram_plain(y, n_fft, hop, n_frames, mode=mode, mag_scale=mag,
                                  sample_rate=sr, mel_bins=mels, n_mfcc=n_mfcc, out_w=spec_width)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    if int8:
        diff = (quantize_entry(got, QUANT).int() - quantize_entry(ref, QUANT).int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean().item() < 0.01
    else:
        err = (got - ref).abs().max().item()
        assert err <= TOLERANCE.get((mode, mag), 2e-5), f"{mode} + {mag}: max abs {err}"


def test_no_tail_variant_patches_both_kernels():
    """scripts/kernel_variants.py times the kernels without their
    per-sample tail by skipping both arrival checks of the committed
    source; it refuses a source where it does not find exactly two."""
    src = (_build.CSRC_DIR / "frontend_kernel.cu").read_text()
    patched = no_tail_source(src)
    assert patched.count("if (true || !last_to_arrive(") == 2
    assert "if (!last_to_arrive(" not in patched
    with pytest.raises(ValueError, match="arrival checks"):
        no_tail_source(patched)
