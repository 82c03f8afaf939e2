"""PyTorch port, the CUDA kernels against their plain versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has none; tests/conftest.py configures
JAX, so run it there with:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

The INT8 leg: each int8-entry specialisation must equal the executor's
quantize of the float kernel's output bit for bit, and its plain version
(quantize of the plain float features) within one code on fewer than 1 %
of codes (the allowance of tests/test_pallas.py); the CUDA integer executor
must equal the golden scores and its own CPU run bit for bit.

Tolerances: 1e-5 for the linear kernel and 2e-5 for the other epilogues
(the JAX package's gates, tests/test_pallas.py) on [0, 1]-normalized
features. Kernel and plain version both compute in float32 (the plain
version with TF32 off) and differ in summation order. The linear mode in
dB is outside those gates and gets 1e-4: a bin 80 dB below the peak holds
a magnitude 1e-4 of it, so a summation-order error relative to the frame
energy grows ~1e4-fold in that bin's dB (measured 7.6e-5 on an H100).

The tile grid (grid="tile") keeps every sum in the sample grid's order, so
it must equal the sample-grid kernel bit for bit, float32 and int8.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import full_fp32
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    frontend_input,
    fused_spectrogram,
    fused_spectrogram_plain,
    kernel_name,
    quantize_entry,
)
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    TFLiteGraph,
    build_executor,
    entry_quant_params,
)
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, flagship_features

GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_int8_flagship_scores.npz"

COMBOS = [("linear", "none"), ("mel", "none"), ("mel", "pwl"), ("mel", "pcen"),
          ("mel", "db"), ("log_mel", "none"), ("mfcc", "none"), ("linear", "pwl"),
          ("linear", "db"), ("linear", "pcen")]
TOLERANCE = {("linear", "none"): 1e-5, ("linear", "db"): 1e-4}
FLAGSHIP = dict(sample_rate=22050, n_fft=512, mel_bins=64, spec_width=256, n_mfcc=20)
# tests/test_pallas.py's small geometry: n_fft 256, hop 250, 32 frames (mfcc 33).
SMALL = dict(sample_rate=8000, n_fft=256, mel_bins=32, spec_width=32, n_mfcc=13)
TILES = (2, 4, 8, 16)


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
    _check(_wave(5, 3, 8000), mode, mag, SMALL, 8000, launches=3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mel", "mfcc"])
def test_more_than_64_mels_on_card(cuda, mode):
    """96 mels take two mel chunks per strip, each recomputing the DFT."""
    geometry = {**FLAGSHIP, "mel_bins": 96}
    _check(_wave(6, 4, 66150), mode, "pwl" if mode == "mel" else "none", geometry, 66150)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_int8_epilogue_on_card(cuda, mode, mag):
    """Each int8-entry specialisation at the flagship geometry, twice in a
    row: bit-equal to quantize(the float kernel's output), and within one
    code of quantize(the plain version) on fewer than 1 % of codes."""
    y = _wave(10, 4, 66150)
    quant = entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
    kw = dict(mode=mode, mag_scale=mag, **FLAGSHIP)
    name = kernel_name(mode, mag, quant=True)
    before = frontend_kernel.launches[name]
    got = [fused_spectrogram(y, quant=quant, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert frontend_kernel.launches[name] == before + 2
    floats = fused_spectrogram(y, **kw)
    bins, out_w = floats.shape[1:]
    assert got[0].shape == (4, 1, out_w, bins) and got[0].dtype == torch.int8
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], quantize_entry(floats, quant))
    T, hop = y.shape[1], y.shape[1] // FLAGSHIP["spec_width"]
    n_frames = 1 + T // hop if mode == "mfcc" else FLAGSHIP["spec_width"]
    with full_fp32():
        plain = quantize_entry(fused_spectrogram_plain(
            y, FLAGSHIP["n_fft"], hop, n_frames, mode=mode, mag_scale=mag,
            sample_rate=FLAGSHIP["sample_rate"], mel_bins=FLAGSHIP["mel_bins"],
            n_mfcc=FLAGSHIP["n_mfcc"], out_w=FLAGSHIP["spec_width"]), quant)
    diff = (got[0].int() - plain.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() < 0.01


@pytest.mark.cuda
def test_int8_executor_matches_golden_on_card(cuda):
    """The CUDA integer executor on the golden's features: bit-equal to the
    JAX executor's scores (which equal the TFLite interpreter's)."""
    x = torch.from_numpy(flagship_features(8)).cuda()
    got = build_executor(TFLiteGraph(FLAGSHIP_TFLITE), 8, device="cuda")(x).cpu().numpy()
    np.testing.assert_array_equal(got, np.load(GOLDEN)["scores"])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_int8_executor_matches_cpu_on_card(cuda, fused):
    """CUDA vs CPU executor on chirp features from the linear kernel: the
    flagship graph on float features, or the fixture graph on the int8
    kernel's entry tensor; bit-equal scores."""
    cfg = ModelConfig.load(Path(__file__).resolve().parents[1]
                           / "artifacts/flagship/bundle/model_config.json")
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    f0 = np.random.default_rng(11).uniform(500.0, 6000.0, (6, 1))
    wave = torch.from_numpy((0.5 * np.sin(2 * np.pi * f0 * t * (1 + 0.3 * t))).astype(np.float32))
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    quant = None
    if fused:
        graph = entry_transpose_fixture(graph)
        quant = entry_quant_params(graph)
    feats = frontend_input(wave.cuda(), cfg, quant=quant)
    got = build_executor(graph, 6, device="cuda", prequantized_input=fused)(feats)
    ref = build_executor(graph, 6, device="cpu", prequantized_input=fused)(feats.cpu())
    assert torch.isfinite(got).all() and got.shape == (6, 100)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["small", "flagship"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_tile_grid_equals_sample_grid_on_card(cuda, mode, mag, int8, geometry):
    """Every tile of TILES at B=16 equals the sample-grid kernel bit for
    bit, float32 and int8. Small geometry: a 64-row strip holds two
    samples' 32 frames (mfcc: 33, strips straddle samples); flagship: 256
    frames (mfcc: 257, one strip in five straddles)."""
    geometry, T = (SMALL, 8000) if geometry == "small" else (FLAGSHIP, 66150)
    y = _wave(12, 16, T)
    quant = (entry_quant_params(entry_transpose_fixture(TFLiteGraph(FLAGSHIP_TFLITE)))
             if int8 else None)
    kw = dict(mode=mode, mag_scale=mag, quant=quant, **geometry)
    sample = fused_spectrogram(y, **kw)
    name = kernel_name(mode, mag, int8, "tile")
    for tile in TILES:
        before = frontend_kernel.launches[name]
        got = fused_spectrogram(y, grid="tile", batch_tile=tile, **kw)
        torch.cuda.synchronize()
        assert frontend_kernel.launches[name] == before + 1
        assert got.shape == sample.shape and got.dtype == sample.dtype
        assert torch.equal(got, sample), (
            f"{name} tile {tile}: max abs {(got.float() - sample.float()).abs().max().item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "pwl"), ("mfcc", "none"),
                                      ("linear", "pcen")])
def test_tile_grid_leaves_counters_at_zero(cuda, mode, mag):
    """After a tile-grid launch whose strips straddle samples, every
    per-sample arrival counter is back at zero (blocks that arrive at two
    samples count once at each)."""
    y = _wave(13, 8, 8000)
    fused_spectrogram(y, mode=mode, mag_scale=mag, grid="tile", batch_tile=4, **SMALL)
    torch.cuda.synchronize()
    counters = [buf for (dev, _), buf in frontend_kernel._arrival_counters.items()
                if dev == y.device]
    assert counters and all(int(buf.count_nonzero()) == 0 for buf in counters)


@pytest.mark.cuda
def test_tile_grid_contract_on_card(cuda):
    """B=6 does not split into groups of 4: ValueError before any launch."""
    before = frontend_kernel.launches.total()
    with pytest.raises(ValueError, match="batch_tile"):
        fused_spectrogram(_wave(14, 6, 8000), grid="tile", batch_tile=4, **SMALL)
    assert frontend_kernel.launches.total() == before
