"""PyTorch port, the fused frontend's tile grid against the JAX package.

`fused_spectrogram(grid="tile", batch_tile=t)` on a CPU tensor (the
plain version, which serves both grids: they compute one function) is held against the JAX kernel's tile grid
(`_kernel_tile`) in Pallas interpret mode: atol 2e-5 on [0, 1]-normalized
features, and int8 codes at most one apart on fewer than 1 % of codes,
the gates tests/test_pallas.py holds the JAX tile grid to. Both sides are
float32 and differ in summation order (the JAX tile and sample grids
themselves differ by ~1e-6 on the CPU, from XLA's blocking of a taller
product). Inputs are made with numpy from a seed and fed to both packages.

The strip arithmetic the CUDA kernels count arrivals with (`tile_layout`,
and the kernels' own formula for the samples a strip touches) is checked
exhaustively here against a row-by-row enumeration; the kernels themselves
run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from birdnet_stm32_tpu.ops.pallas.frontend_kernel import fused_hybrid_frontend as j_hybrid
from birdnet_stm32_tpu.ops.pallas.frontend_kernel import fused_spectrogram as j_fused
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import (
    STRIP_ROWS,
    fused_hybrid_frontend,
    fused_spectrogram,
    kernel_name,
    tile_layout,
)
from tests.test_torch_cpu_warmup import warm_up

warm_up()

# tests/test_pallas.py:107-115, and the linear mode with a magnitude scale.
COMBOS = [("linear", "none"), ("mel", "none"), ("mel", "pwl"), ("mel", "pcen"),
          ("mel", "db"), ("log_mel", "none"), ("mfcc", "none"), ("linear", "pwl"),
          ("linear", "db"), ("linear", "pcen")]
# The small geometry of tests/test_pallas.py:124-125 (32 frames, mfcc 33).
SMALL = dict(sample_rate=8000, n_fft=256, mel_bins=32, spec_width=32, n_mfcc=13)
FLAGSHIP = dict(sample_rate=22050, n_fft=512, mel_bins=64, spec_width=256, n_mfcc=20)
QUANT = (0.00392156932502985, -128)


def _wave(seed, B, T):
    return np.random.default_rng(seed).normal(0, 0.5, (B, T)).astype(np.float32)


def _both(y, tile, geometry, **kw):
    """(port on the CPU, JAX interpret mode) tile grids on the same input."""
    got = fused_spectrogram(torch.from_numpy(y), grid="tile", batch_tile=tile, **geometry, **kw)
    ref = j_fused(jnp.asarray(y), grid="tile", batch_tile=tile, interpret=True, **geometry, **kw)
    return got, np.asarray(ref)


@pytest.mark.parametrize("tile", [2, 4, 8])
@pytest.mark.parametrize("mode,mag", COMBOS)
def test_tile_grid_matches_jax(mode, mag, tile):
    """B=8 at the small geometry: a 64-row strip holds two samples' 32
    frames (mfcc: 33, so strips straddle samples)."""
    got, ref = _both(_wave(0, 8, 8000), tile, SMALL, mode=mode, mag_scale=mag)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("tile", [2, 8])
@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "pwl")])
def test_tile_grid_int8_matches_jax(mode, mag, tile):
    got, ref = _both(_wave(3, 8, 8000), tile, SMALL, mode=mode, mag_scale=mag, quant=QUANT)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("mode,mag", [("mel", "pwl"), ("mfcc", "none")])
def test_tile_grid_matches_jax_at_flagship_geometry(mode, mag):
    """B=4, tile 2, T=66150: mfcc stacks 2 x 257 frames per group."""
    got, ref = _both(_wave(1, 4, 66150), 2, FLAGSHIP, mode=mode, mag_scale=mag)
    assert got.shape == ref.shape == (4, 20 if mode == "mfcc" else 64, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_hybrid_tile_grid_matches_jax():
    """fused_hybrid_frontend(grid='tile') at an explicit geometry."""
    y = _wave(2, 4, 8000)
    got = fused_hybrid_frontend(torch.from_numpy(y), 256, 250, 32, batch_tile=4, grid="tile")
    ref = np.asarray(j_hybrid(jnp.asarray(y), 256, 250, 32, batch_tile=4, interpret=True,
                              grid="tile"))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("quant", [None, QUANT])
@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "db"), ("mfcc", "none")])
def test_tile_grid_plain_equals_sample_grid(mode, mag, quant):
    """On the CPU both grids run the same plain maths: equal values, and
    batch_tile 1 is the sample grid; no launch is counted."""
    y = torch.from_numpy(_wave(4, 4, 8000))
    kw = dict(mode=mode, mag_scale=mag, quant=quant, **SMALL)
    before = frontend_kernel.launches.total()
    sample = fused_spectrogram(y, **kw)
    for tile in (1, 2, 4):
        assert torch.equal(fused_spectrogram(y, grid="tile", batch_tile=tile, **kw), sample)
    assert frontend_kernel.launches.total() == before


def test_sample_grid_ignores_batch_tile():
    """As in JAX: grid='sample' takes any B, whatever batch_tile says."""
    y = torch.from_numpy(_wave(6, 6, 8000))
    assert torch.equal(fused_spectrogram(y, batch_tile=4, **SMALL), fused_spectrogram(y, **SMALL))


@pytest.mark.parametrize("kw,match", [(dict(grid="batch"), "grid"),
                                      (dict(grid="tile", batch_tile=4), "batch_tile"),
                                      (dict(grid="tile", batch_tile=0), "batch_tile")])
def test_tile_grid_contract(kw, match):
    """Unknown grids and batches that do not split into whole groups raise
    ValueError, naming the argument, in the port as in JAX."""
    y = _wave(7, 6, 8000)
    with pytest.raises(ValueError, match=match):
        fused_spectrogram(torch.from_numpy(y), **SMALL, **kw)
    if kw.get("batch_tile") != 0:  # JAX divides by it
        with pytest.raises(ValueError, match=match):
            j_fused(jnp.asarray(y), interpret=True, **SMALL, **kw)


@pytest.mark.parametrize("kw,match", [(dict(grid="batch"), "grid"),
                                      (dict(grid="tile", batch_tile=4), "batch_tile")])
def test_hybrid_tile_grid_contract(kw, match):
    """fused_hybrid_frontend passes grid and batch_tile on: the same
    ValueErrors as fused_spectrogram, in the port as in JAX."""
    y = _wave(8, 6, 8000)
    with pytest.raises(ValueError, match=match):
        fused_hybrid_frontend(torch.from_numpy(y), 256, 250, 32, **kw)
    with pytest.raises(ValueError, match=match):
        j_hybrid(jnp.asarray(y), 256, 250, 32, interpret=True, **kw)


def test_tile_kernel_names():
    assert kernel_name("linear", "none", grid="tile") == "fused_spectrogram_linear_tile"
    assert kernel_name("mel", "pwl", True, "tile") == "fused_spectrogram_mel_pwl_int8_tile"
    assert kernel_name("mfcc", "pcen", grid="tile") == "fused_spectrogram_mfcc_tile"
    assert kernel_name("mel", "pwl", True) == "fused_spectrogram_mel_pwl_int8"


def strip_samples(strip, n_frames, tile, strip_rows=STRIP_ROWS):
    """The samples a kernel block of strip `strip` arrives at: g_lo..g_hi of
    ops/csrc/frontend_kernel.cu, in the same integer arithmetic."""
    r0 = strip * strip_rows
    return range(r0 // n_frames, (min(r0 + strip_rows, tile * n_frames) - 1) // n_frames + 1)


def _enumerate(n_frames, tile, strip_rows):
    """Row by row: {sample: sorted strips holding its rows} and
    {strip: sorted samples it holds rows of}, and each (sample, frame)'s
    row."""
    strips_of, samples_of, rows = {}, {}, {}
    for r in range(tile * n_frames):
        g, frame, k = r // n_frames, r % n_frames, r // strip_rows
        strips_of.setdefault(g, set()).add(k)
        samples_of.setdefault(k, set()).add(g)
        rows[(g, frame)] = r
    return strips_of, samples_of, rows


@pytest.mark.parametrize("strip_rows", [STRIP_ROWS, 16])
def test_tile_layout_exhaustive(strip_rows):
    """Every geometry with up to 300 frames and 17 samples per group: every
    (sample, frame) has exactly one row; each sample's first strip and
    strip count, and each strip's samples (what a kernel block arrives
    at), match the enumeration. Blocks arriving at a sample, summed over
    strips, equal its count: the kernels' counters end at zero."""
    for n_frames in range(1, 301):
        for tile in (1, 2, 3, 4, 7, 8, 16, 17):
            strips_of, samples_of, rows = _enumerate(n_frames, tile, strip_rows)
            assert len(rows) == len(set(rows.values())) == tile * n_frames
            layout = tile_layout(n_frames, tile, strip_rows)
            assert layout.shape == (tile, 2) and layout.dtype == np.int32
            for g in range(tile):
                ks = sorted(strips_of[g])
                assert ks == list(range(ks[0], ks[-1] + 1))
                assert (layout[g, 0], layout[g, 1]) == (ks[0], len(ks))
            n_strips = -(-tile * n_frames // strip_rows)
            assert sorted(samples_of) == list(range(n_strips))
            arrivals = np.zeros(tile, int)
            for k in range(n_strips):
                got = strip_samples(k, n_frames, tile, strip_rows)
                assert list(got) == sorted(samples_of[k])
                arrivals[list(got)] += 1
            np.testing.assert_array_equal(arrivals, layout[:, 1])


@pytest.mark.parametrize("n_frames,tile,expected", [
    (64, 4, [[0, 1], [1, 1], [2, 1], [3, 1]]),   # strips end exactly on samples
    (65, 2, [[0, 2], [1, 2]]),                   # one row past: sample 0 spills into strip 1
    (63, 3, [[0, 1], [0, 2], [1, 2]]),           # one row short
    (32, 4, [[0, 1], [0, 1], [1, 1], [1, 1]]),   # two samples per strip
    (257, 8, [[0, 5], [4, 5], [8, 5], [12, 5], [16, 5], [20, 5], [24, 5], [28, 5]]),
    (256, 2, [[0, 4], [4, 4]]),                  # the flagship's 256 frames
])
def test_tile_layout_boundaries(n_frames, tile, expected):
    """The cases named: a strip ending exactly on a sample boundary, one row
    past it, one row short; the flagship mfcc group of 8 x 257 frames takes
    33 strips, not the sample grid's 40."""
    np.testing.assert_array_equal(tile_layout(n_frames, tile), expected)
    if (n_frames, tile) == (257, 8):
        assert -(-8 * 257 // STRIP_ROWS) == 33
        assert list(strip_samples(32, 257, 8)) == [7]
        assert list(strip_samples(4, 257, 8)) == [0, 1]


def test_straddling_strip_division_is_exact():
    """A strip that straddles samples maps its row f to sample
    s0 + (f0 + f) / n_frames with one __umulhi by ceil(2^32 / n_frames)
    (ops/csrc/frontend_kernel.cu::dft_tile); the launchers keep
    n_frames + 64 below 2^16. Exact for every frame count up to 2048 and
    for 1000 larger ones, over every numerator a strip can give."""
    rng = np.random.default_rng(0)
    for n in list(range(1, 2049)) + rng.integers(2049, 65535 - STRIP_ROWS, 1000).tolist():
        a = np.arange(n + STRIP_ROWS, dtype=np.uint64)
        magic = np.uint64((0xFFFFFFFF // n + 1) & 0xFFFFFFFF)
        q = a if n == 1 else (a * magic) >> np.uint64(32)
        np.testing.assert_array_equal(q, a // np.uint64(n))
