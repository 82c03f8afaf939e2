"""PyTorch port, the CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has none; tests/conftest.py configures
JAX, so run it there with:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: 1e-5 for the linear kernel and 2e-5 for the other epilogues
(the JAX package's gates, tests/test_pallas.py) on [0, 1]-normalized
features. Kernel and plain version both compute in float32 (the plain
version with TF32 off) and differ in summation order. The linear mode in
dB is outside those gates and gets 1e-4: a bin 80 dB below the peak holds
a magnitude 1e-4 of it, so a summation-order error relative to the frame
energy grows ~1e4-fold in that bin's dB (measured 7.6e-5 on an H100).
"""

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    fused_spectrogram,
    fused_spectrogram_plain,
    kernel_name,
)

COMBOS = [("linear", "none"), ("mel", "none"), ("mel", "pwl"), ("mel", "pcen"),
          ("mel", "db"), ("log_mel", "none"), ("mfcc", "none"), ("linear", "pwl"),
          ("linear", "db"), ("linear", "pcen")]
TOLERANCE = {("linear", "none"): 1e-5, ("linear", "db"): 1e-4}
FLAGSHIP = dict(sample_rate=22050, n_fft=512, mel_bins=64, spec_width=256, n_mfcc=20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _wave(seed, B, T):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 0.5, (B, T)).astype(np.float32)).cuda()


def _check(y, mode, mag, geometry, T, launches=1):
    """Kernel vs plain version on y; the kernel launches `launches` times."""
    name = kernel_name(mode, mag)
    before = frontend_kernel.launches[name]
    for _ in range(launches):
        got = fused_spectrogram(y, mode=mode, mag_scale=mag, **geometry)
    torch.cuda.synchronize()
    assert frontend_kernel.launches[name] == before + launches
    hop = T // geometry["spec_width"]
    full = 1 + T // hop
    n_frames = full if mode == "mfcc" else min(geometry["spec_width"], full)
    with full_fp32():
        ref = fused_spectrogram_plain(
            y, geometry["n_fft"], hop, n_frames, mode=mode, mag_scale=mag,
            sample_rate=geometry["sample_rate"], mel_bins=geometry["mel_bins"],
            n_mfcc=geometry["n_mfcc"], out_w=min(geometry["spec_width"], n_frames))
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    tol = TOLERANCE.get((mode, mag), 2e-5)
    err = (got - ref).abs().max().item()
    assert err <= tol, f"{name}: max abs {err} > {tol}"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    """The linear (hybrid) kernel at the flagship geometry."""
    _check(_wave(9, 8, 66150), "linear", "none", FLAGSHIP, 66150)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", COMBOS[1:])
def test_epilogue_kernel_matches_plain_on_card(cuda, mode, mag):
    """Each features-kernel specialisation at the flagship geometry; the
    linear ones keep their 257 bins in the scratch, not shared memory."""
    _check(_wave(4, 8, 66150), mode, mag, FLAGSHIP, 66150)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_kernel_matches_plain_at_small_geometry(cuda, mode, mag):
    """tests/test_pallas.py's small geometry (n_fft 256, hop 250, 32 mels,
    13 mfcc), three launches in a row: each kernel leaves its arrival
    counters at zero for the next."""
    geometry = dict(sample_rate=8000, n_fft=256, mel_bins=32, spec_width=32, n_mfcc=13)
    _check(_wave(5, 3, 8000), mode, mag, geometry, 8000, launches=3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mel", "mfcc"])
def test_more_than_64_mels_on_card(cuda, mode):
    """96 mels take two mel chunks per strip, each recomputing the DFT."""
    geometry = {**FLAGSHIP, "mel_bins": 96}
    _check(_wave(6, 4, 66150), mode, "pwl" if mode == "mel" else "none", geometry, 66150)
