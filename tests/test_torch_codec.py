"""PyTorch port, the libav codec (audio/native.py over
audio/csrc/audio_codec.cc) and the compressed-file paths of audio/io.py,
data/dataset.py and the loader, against the JAX package's codec.

Both codecs are the same source built with the same flags against the
same libav, so decodes are held bit-equal: codec_decode (whole, windowed,
after the undercounted-duration retry), codec_info / audio_info,
load_audio_window, cached_waveform, dataset discovery and AudioLoader's
batches on a folder of WAV, FLAC, OGG and MP3 files. Round trips by format
hold the decoded tone at cosine > 0.98 after aligning the encoder delay
(tests/test_audio_codec.py's gate); FLAC offset decodes are sample-exact.
Every test skips where pkg-config finds no libav, as the JAX codec tests
do.
"""

import numpy as np
import pytest

from birdnet_stm32_tpu.audio import io as JIO
from birdnet_stm32_tpu.audio import native as jnative
from birdnet_stm32_tpu.data import dataset as JD
from birdnet_stm32_tpu.data.pipeline import AudioLoader as JAudioLoader
from birdnet_stm32_tpu.data.worker import LoaderConfig as JLoaderConfig
from birdnet_stm32_tpu_torch.audio import io as PIO
from birdnet_stm32_tpu_torch.audio import native
from birdnet_stm32_tpu_torch.data import dataset as D
from birdnet_stm32_tpu_torch.data.pipeline import AudioLoader, LoaderConfig

SR = 22050
FORMATS = ["flac", "ogg", "mp3", "m4a"]


@pytest.fixture(autouse=True)
def _needs_codec():
    if not native.codec_available():
        pytest.skip(f"libav codec not available here ({native.CODEC.error})")
    if not jnative.codec_available():
        pytest.skip("the JAX package's codec is not built here")


def _tone(seconds=2.0, f=1200.0, sr=SR):
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * f * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(
        np.float32)


@pytest.mark.parametrize("ext", FORMATS)
def test_roundtrip_bit_equal_to_jax(tmp_path, ext):
    y = _tone()
    p = tmp_path / f"tone.{ext}"
    native.codec_encode(p, y, SR)
    got, sr = native.codec_decode(p)
    ref, jsr = jnative.codec_decode(p)
    assert sr == jsr == SR
    np.testing.assert_array_equal(got, ref)
    assert native.codec_info(p) == jnative.codec_info(p)
    assert abs(len(got) - len(y)) < SR // 4  # codec delay and padding
    k = SR
    lag = int(np.argmax(np.correlate(got[: k + 2048], y[:k], mode="valid")))
    a, b = got[lag : lag + k], y[:k]
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    assert cos > 0.98, f"{ext}: cosine {cos}"
    # A file the JAX codec wrote decodes alike in the port.
    q = tmp_path / f"jax.{ext}"
    jnative.codec_encode(q, y, SR)
    np.testing.assert_array_equal(native.codec_decode(q)[0], jnative.codec_decode(q)[0])


def test_offset_decode_sample_exact_on_flac(tmp_path):
    p = tmp_path / "t.flac"
    native.codec_encode(p, _tone(5.0), SR)
    full, _ = native.codec_decode(p)
    for start in (0, 1000, SR // 2, 2 * SR + 7, 4 * SR):
        n = SR // 3
        win, _ = native.codec_decode(p, offset_frames=start, max_frames=n)
        np.testing.assert_array_equal(win, full[start : start + n], err_msg=f"offset {start}")
        np.testing.assert_array_equal(
            win, jnative.codec_decode(p, offset_frames=start, max_frames=n)[0])


def test_undercounted_duration_retries(tmp_path, monkeypatch):
    """A container that undercounts its length (VBR mp3 without a Xing
    header): the whole-file decode doubles its buffer until it stops short,
    and returns the whole stream."""
    p = tmp_path / "t.mp3"
    native.codec_encode(p, _tone(4.0), SR)
    full, _ = native.codec_decode(p)
    calls = []
    real = native._codec()

    def counting(*args):
        calls.append(args[4])  # the buffer's length
        return real.codec_decode_f32(*args)

    monkeypatch.setattr(native, "codec_info", lambda path: (SR, 1, 100))
    monkeypatch.setattr(native, "_codec", lambda: type("L", (), {"codec_decode_f32":
                                                                 staticmethod(counting)})())
    got, sr = native.codec_decode(p)
    # 4 s of audio against a first buffer of 2 s + 4096 frames: one retry.
    assert sr == SR and len(calls) == 2 and calls[1] > calls[0]
    np.testing.assert_array_equal(got, full)


def test_corrupt_files_degrade_to_empty(tmp_path):
    good = tmp_path / "good.flac"
    native.codec_encode(good, _tone(), SR)
    truncated = tmp_path / "bad.flac"
    truncated.write_bytes(good.read_bytes()[: good.stat().st_size // 8])
    garbage = tmp_path / "junk.flac"
    garbage.write_bytes(b"\x00\xde\xad" * 1000)
    empty = tmp_path / "empty.ogg"
    empty.write_bytes(b"")
    for p in (truncated, garbage, empty):
        got = PIO.load_audio_window(p, 16000, max_duration=10, chunk_duration=1.0)
        ref = JIO.load_audio_window(p, 16000, max_duration=10, chunk_duration=1.0)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, ref)
    assert PIO.load_audio_window(empty, 16000).size == 0
    with pytest.raises(ValueError, match="cannot probe"):
        native.codec_info(empty)
    with pytest.raises(ValueError, match="cannot probe"):
        PIO.audio_info(empty)


@pytest.mark.parametrize("ext", ["flac", "ogg", "mp3"])
def test_io_paths_bit_equal(tmp_path, ext):
    """audio_info, load_audio_window (model rate and resampled, random
    offsets from equal generators), load_audio_file and cached_waveform."""
    p = tmp_path / f"t.{ext}"
    native.codec_encode(p, _tone(6.0), SR)
    got, ref = PIO.audio_info(p), JIO.audio_info(p)
    assert (got.sample_rate, got.channels, got.frames) == (ref.sample_rate, ref.channels,
                                                           ref.frames)
    assert got.duration == ref.duration and abs(got.duration - 6.0) < 0.25
    for rate in (SR, 16000):
        for seed in (0, 1):
            kw = dict(max_duration=3.0, chunk_duration=1.0)
            w = PIO.load_audio_window(p, rate, rng=np.random.default_rng(seed), **kw)
            assert w.size == 3 * rate
            np.testing.assert_array_equal(
                w, JIO.load_audio_window(p, rate, rng=np.random.default_rng(seed), **kw))
        np.testing.assert_array_equal(PIO.load_audio_file(p, rate, chunk_duration=1.0),
                                      JIO.load_audio_file(p, rate, chunk_duration=1.0))
        c = PIO.cached_waveform(p, rate, tmp_path / "pc")
        np.testing.assert_array_equal(c, JIO.cached_waveform(p, rate, tmp_path / "jc"))
        assert c.size > 5 * rate
        assert sorted(x.name for x in (tmp_path / "pc").glob("*.npy")) == sorted(
            x.name for x in (tmp_path / "jc").glob("*.npy"))
        np.testing.assert_array_equal(
            PIO.load_audio_window(p, rate, random_offset=False, cache_dir=tmp_path / "pc"),
            JIO.load_audio_window(p, rate, random_offset=False, cache_dir=tmp_path / "jc"))


@pytest.fixture(scope="module")
def mixed_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(0)
    for ci, cls in enumerate(["a", "b", "noise"]):
        for i, ext in enumerate(["wav", "flac", "ogg", "mp3"]):
            y = _tone(rng.uniform(1.5, 3.5), f=300 + 500 * ci + 40 * i, sr=16000)
            y = y + rng.normal(0, 0.05, y.size).astype(np.float32)
            if ext == "wav":
                PIO.save_wav(y, root / cls / f"{cls}_{i}.wav", 16000)
            else:
                native.codec_encode(root / cls / f"{cls}_{i}.{ext}", y, 16000)
    return root


def test_discovery_and_loader_bit_equal(mixed_folder):
    assert D.supported_audio_extensions() == JD.supported_audio_extensions()
    got, ref = (D.load_file_paths_from_directory(mixed_folder),
                JD.load_file_paths_from_directory(mixed_folder))
    assert got == ref and len(got[0]) == 12 and got[2] == ["a", "b"]
    paths, labels, classes = got

    def batches(cls, cfg_cls):
        cfg = cfg_cls(sample_rate=8000, chunk_duration=1.0, seed=3, max_chunks_per_file=2)
        loader = cls(paths, D.one_hot_labels(labels, classes), cfg, batch_size=4,
                     shuffle=True, infinite=True, reservoir_size=8, num_workers=0)
        out = []
        for x, y in loader:
            out.append((x, y))
            if len(out) == 4:
                return out

    for (x, y), (jx, jy) in zip(batches(AudioLoader, LoaderConfig),
                                batches(JAudioLoader, JLoaderConfig)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert np.abs(x).max() > 0.5  # decoded audio, not the empty-file noise rows
