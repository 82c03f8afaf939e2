"""PyTorch port, the native WAV reader and resampler (audio/native.py,
built from audio/csrc/audio_native.cc) against the JAX package's
(native/audio_native.cc through birdnet_stm32_tpu/audio/native.py).

Both libraries are the same source built with the same flags, so every
result is held bit-equal: wav_info, windowed and whole reads of PCM
8/16/24/32 and float32/64 WAVs in mono and stereo, resample_poly at four
rate pairs (and within 5e-6 of scipy, which both match), and the audio/io.py
paths that use them (fast_resample, load_audio_window). Tests skip where the
library cannot be built (no g++).
"""

import numpy as np
import pytest

from birdnet_stm32_tpu.audio import io as JIO
from birdnet_stm32_tpu.audio import native as jnative
from birdnet_stm32_tpu_torch.audio import io as PIO
from birdnet_stm32_tpu_torch.audio import native
from tests.test_torch_audio_io import FORMATS, _signal, _write_wav

SR = 8000


@pytest.fixture(autouse=True)
def _needs_library():
    if not native.available():
        pytest.skip(f"native library not built here ({native.NATIVE.error})")
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built here")


@pytest.mark.parametrize("bits,fmt,ch", FORMATS, ids=lambda v: str(v))
def test_wav_read_bit_equal(tmp_path, bits, fmt, ch):
    path = tmp_path / "x.wav"
    _write_wav(path, _signal(bits * ch, int(2.3 * SR), ch), SR, bits, fmt)
    assert native.wav_info(path) == jnative.wav_info(path) == (SR, ch, int(2.3 * SR))
    whole = native.wav_read(path)
    np.testing.assert_array_equal(whole, jnative.wav_read(path))
    for start, n in ((0, 100), (777, SR), (int(2.3 * SR) - 50, 400)):
        got = native.wav_read(path, start_frame=start, n_frames=n)
        np.testing.assert_array_equal(got, jnative.wav_read(path, start_frame=start, n_frames=n))
        np.testing.assert_array_equal(got, whole[start : start + n])
    # The numpy reader's mean downmix agrees for one or two channels.
    frames = PIO._decode_frames(PIO.wav_info(path), 0, PIO.wav_info(path).frames)
    np.testing.assert_array_equal(whole, frames.mean(axis=1).astype(np.float32))


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 22050), (44100, 22050), (16000, 22050),
                                          (22050, 8000)])
def test_resample_bit_equal(sr_in, sr_out):
    x = np.random.default_rng(sr_in).normal(0, 0.3, int(sr_in * 1.7)).astype(np.float32)
    got = native.resample_poly(x, sr_in, sr_out)
    np.testing.assert_array_equal(got, jnative.resample_poly(x, sr_in, sr_out))
    np.testing.assert_array_equal(PIO.fast_resample(x, sr_in, sr_out), got)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    ref = resample_poly(x, sr_out // g, sr_in // g)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-6)


def test_load_audio_window_bit_equal(tmp_path):
    """The window read and resample of audio/io.py through the library, at
    the model rate and resampled, random offsets from equal generators."""
    path = tmp_path / "long.wav"
    _write_wav(path, _signal(5, int(6.1 * 44100), 2), 44100, 16, 1)
    for rate in (44100, 22050):
        for seed in (0, 1):
            got = PIO.load_audio_window(path, rate, max_duration=3.0, chunk_duration=1.0,
                                        rng=np.random.default_rng(seed))
            ref = JIO.load_audio_window(path, rate, max_duration=3.0, chunk_duration=1.0,
                                        rng=np.random.default_rng(seed))
            assert got.size == 3 * rate
            np.testing.assert_array_equal(got, ref)


def test_errors_and_switch(tmp_path, monkeypatch):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    with pytest.raises(ValueError, match="cannot parse WAV"):
        native.wav_info(bad)
    assert PIO.load_audio_window(bad, SR).size == 0
    # The switch turns a fresh library off before any build, and says so.
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    lib = native._Library("native", native._declare_native)
    assert lib.get() is None and native.NO_NATIVE_ENV in lib.error
    monkeypatch.setattr(native, "NATIVE", lib)
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.wav_read(bad)
    # audio/io.py falls back to numpy and scipy.
    path = tmp_path / "x.wav"
    _write_wav(path, _signal(3, 3 * SR, 1), SR, 16, 1)
    np.testing.assert_array_equal(PIO.load_audio_window(path, SR),
                                  JIO.load_audio_window(path, SR))


def test_build_path_tracks_source_and_flags():
    so = native.library_path("native")
    assert so.parent == native.BUILD_DIR and so.name.startswith("libaudio_native-")
    assert native.library_path("native", ("-DX",)) != so
    assert so.exists()  # built by the first use above
