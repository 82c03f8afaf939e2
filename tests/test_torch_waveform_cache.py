"""PyTorch port, the decoded-waveform cache (audio/io.py::cached_waveform,
`cache_dir=` of load_audio_window / load_audio_file, the serving decode and
the training loader) against the JAX package's cache, on WAV files written
here.

The JAX side runs with its native reader and resampler switched off
(monkeypatch of birdnet_stm32_tpu.audio.native.available; no JAX file
changes), so both packages decode and resample through numpy and scipy.
Tolerance: bit-equal, entries and windows alike, and the same cache key.
"""

import os
import struct

import numpy as np
import pytest

from birdnet_stm32_tpu.audio import io as JIO
from birdnet_stm32_tpu.audio import native as jnative
from birdnet_stm32_tpu_torch.audio import io as PIO
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.data.pipeline import AudioLoader, LoaderConfig
from birdnet_stm32_tpu_torch.data.worker import process_file
from birdnet_stm32_tpu_torch.models import serving as PS
from tests.test_torch_cpu_warmup import warm_up

warm_up()

SR = 22050


def _signal(seed: int, n: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000.0
    x = 0.6 * np.sin(2 * np.pi * rng.uniform(300, 3000, (1, channels)) * t[:, None])
    return np.clip(x + rng.normal(0, 0.05, (n, channels)), -1, 1).astype(np.float32)


def _write(path, x: np.ndarray, sr: int, fmt: str) -> None:
    """[T, C] float in [-1, 1] as PCM16 or float32 WAV."""
    channels = x.shape[1]
    if fmt == "float32":
        data, tag, bits = x.astype("<f4").tobytes(), 3, 32
    else:
        data, tag, bits = (np.round(x * 32767).astype("<i2")).tobytes(), 1, 16
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
            + b"data" + struct.pack("<I", len(data)) + data)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


# (name, source rate, channels, sample format): mono and stereo PCM16 and
# float32 at the target rate, and PCM16 at 48 kHz resampled to 22.05 kHz.
FILES = [("mono16", SR, 1, "pcm16"), ("stereo16", SR, 2, "pcm16"),
         ("float32", SR, 1, "float32"), ("rate48k", 48000, 1, "pcm16")]


@pytest.fixture
def numpy_jax(monkeypatch):
    """The JAX package's cache with its native library switched off."""
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache_wavs")
    out = {}
    for i, (name, sr, ch, fmt) in enumerate(FILES):
        _write(root / f"{name}.wav", _signal(i, int(sr * 4.3), ch), sr, fmt)
        out[name] = root / f"{name}.wav"
    return out


def test_cache_key_equals_jax(wavs):
    for path in wavs.values():
        for rate in (SR, 16000):
            assert PIO._cache_key(path, rate) == JIO._cache_key(path, rate)
    assert PIO.CACHE_MAX_DECODED_BYTES == JIO.CACHE_MAX_DECODED_BYTES


@pytest.mark.parametrize("name", [f[0] for f in FILES])
def test_cached_waveform_bit_equal_to_jax(wavs, tmp_path, numpy_jax, name):
    """The miss (decoded here), the hit (a read-only memmap) and the JAX
    package's entry for the same file hold the same float32 bits."""
    path = wavs[name]
    miss = PIO.cached_waveform(path, SR, tmp_path / "port")
    ref = JIO.cached_waveform(path, SR, tmp_path / "jax")
    hit = PIO.cached_waveform(path, SR, tmp_path / "port")
    assert miss.dtype == np.float32 and miss.size > 0
    np.testing.assert_array_equal(miss, ref)
    np.testing.assert_array_equal(hit, ref)
    assert isinstance(hit, np.memmap) and not hit.flags.writeable
    # The entry's file name is the JAX key: either package reads the other's.
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert not list((tmp_path / "port").glob("*.tmp*"))


@pytest.mark.parametrize("name", [f[0] for f in FILES])
@pytest.mark.parametrize("window", [dict(max_duration=60.0), dict(max_duration=2.0),
                                    dict(max_duration=2.0, random_offset=True)],
                         ids=["whole", "capped", "random_offset"])
def test_load_audio_file_cached_bit_equal_to_jax(wavs, tmp_path, numpy_jax, name, window):
    path = wavs[name]
    kw = dict(sample_rate=SR, chunk_duration=1.0, chunk_overlap=0.25, **window)
    for _ in range(2):  # miss, then hit
        np.random.seed(3)  # the random offset draws from numpy's global state
        got = PIO.load_audio_file(path, cache_dir=tmp_path / "port", **kw)
        np.random.seed(3)
        ref = JIO.load_audio_file(path, cache_dir=tmp_path / "jax", **kw)
        assert got.shape == ref.shape and got.shape[0] > 0
        np.testing.assert_array_equal(got, ref)
        assert got.flags.writeable


def test_cached_window_equals_direct_at_the_model_rate(wavs, tmp_path):
    """Without a resample the cached window is the direct window, bit for
    bit (the serving path's guarantee)."""
    for name in ("mono16", "stereo16", "float32"):
        direct = PIO.load_audio_window(wavs[name], SR, max_duration=3.0, chunk_duration=1.0)
        cached = PIO.load_audio_window(wavs[name], SR, max_duration=3.0, chunk_duration=1.0,
                                       cache_dir=tmp_path)
        np.testing.assert_array_equal(cached, direct)


def test_content_failures_cached_environment_failures_not(tmp_path, monkeypatch):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    cache = tmp_path / "cache"
    assert PIO.cached_waveform(bad, SR, cache).size == 0
    entries = list(cache.glob("*.npy"))
    assert len(entries) == 1 and np.load(entries[0]).size == 0  # negative-cached
    assert PIO.load_audio_window(bad, SR, cache_dir=cache).size == 0

    # A compressed file: the port has no codec, a miss that is not persisted.
    mp3 = tmp_path / "x.mp3"
    mp3.write_bytes(b"ID3" + bytes(64))
    assert PIO.cached_waveform(mp3, SR, tmp_path / "cache2").size == 0
    assert not (tmp_path / "cache2").exists()

    good = tmp_path / "good.wav"
    _write(good, _signal(9, SR * 2, 1), SR, "pcm16")

    def oserror(*a, **k):
        raise OSError("too many open files")

    monkeypatch.setattr(PIO, "_decode_frames", oserror)
    assert PIO.cached_waveform(good, SR, tmp_path / "cache3").size == 0
    assert not list((tmp_path / "cache3").glob("*.npy"))  # not persisted
    monkeypatch.undo()
    y = PIO.cached_waveform(good, SR, tmp_path / "cache3")  # retried and persisted
    assert y.size == SR * 2 and len(list((tmp_path / "cache3").glob("*.npy"))) == 1


def test_rewritten_file_is_a_miss(tmp_path):
    path = tmp_path / "a.wav"
    _write(path, _signal(1, SR * 2, 1), SR, "pcm16")
    first = np.array(PIO.cached_waveform(path, SR, tmp_path / "c"))
    _write(path, _signal(2, SR * 3, 1), SR, "pcm16")
    os.utime(path, ns=(1, 10**18))
    second = PIO.cached_waveform(path, SR, tmp_path / "c")
    assert second.size == SR * 3 and first.size == SR * 2
    assert len(list((tmp_path / "c").glob("*.npy"))) == 2


def test_file_over_the_cap_takes_the_direct_path(wavs, tmp_path, monkeypatch):
    monkeypatch.setattr(PIO, "CACHE_MAX_DECODED_BYTES", 1000)
    got = PIO.load_audio_window(wavs["mono16"], SR, max_duration=2.0, chunk_duration=1.0,
                                cache_dir=tmp_path / "c")
    ref = PIO.load_audio_window(wavs["mono16"], SR, max_duration=2.0, chunk_duration=1.0)
    np.testing.assert_array_equal(got, ref)
    assert not (tmp_path / "c").exists()


def test_serving_decode_through_the_cache(wavs, tmp_path):
    """decode_for_classify and chunks_for_classify_int16 with a cache_dir:
    the same chunks as without it at the model rate; the int16 fallback of
    a stereo file requantizes the cached decode."""
    cfg = ModelConfig(sample_rate=SR, chunk_duration=1.0, fft_length=512, num_mels=64,
                      spec_width=128)
    for name in ("mono16", "stereo16"):
        for kw in ({}, {"int16_io": True}, {"ulaw_io": True}):
            a = PS.decode_for_classify(wavs[name], cfg, **kw)[0]
            b = PS.decode_for_classify(wavs[name], cfg, cache_dir=str(tmp_path), **kw)[0]
            np.testing.assert_array_equal(a, b)
    assert len(list(tmp_path.glob("*.npy"))) == 2  # raw codes bypass the cache


def test_loader_trains_from_the_cache(wavs, tmp_path):
    """LoaderConfig(cache_dir=...) is accepted; the float feed's chunks
    through the cache equal the direct decode's at the model rate."""
    labels = np.eye(len(FILES), dtype=np.float32)
    paths = [str(wavs[f[0]]) for f in FILES]
    rows = {}
    for cache in (None, str(tmp_path / "c")):
        cfg = LoaderConfig(sample_rate=SR, chunk_duration=1.0, num_classes=len(FILES),
                           seed=5, cache_dir=cache)
        rows[cache] = [process_file((p, labels[i], cfg, i)) for i, p in enumerate(paths[:3])]
        loader = AudioLoader(paths, labels, cfg, batch_size=4, num_workers=0,
                             shuffle=False, infinite=False)
        batches = list(loader)
        assert batches and all(x.shape[1] == SR and np.isfinite(x).all() for x, _ in batches)
    for got, ref in zip(rows[str(tmp_path / "c")], rows[None]):
        for (x, y), (rx, ry) in zip(got, ref):
            np.testing.assert_array_equal(x, rx)
            np.testing.assert_array_equal(y, ry)
    assert len(list((tmp_path / "c").glob("*.npy"))) == len(FILES)
