"""PyTorch port, WAV decode and the serving decode path (audio/io.py,
evaluation/metrics.py::chunks_for_file, models/serving.py::
decode_for_classify and chunks_for_classify_int16) against the JAX
package, on WAV files written here.

Tolerances: bit-equal for every format at the model rate (PCM 8/16/24/32,
float32/64, mono and stereo; both packages decode through their native
libraries in this environment, built from the same source, which downmix
as acc * (1/C), equal to numpy's mean for one or two channels, as the
port's numpy reader is); atol 2e-5 where a resample is involved (scipy's
resample_poly, which the port uses without its native library, is within
about 5e-7 of the native resampler).
"""

import struct
import wave as wave_mod
from dataclasses import astuple

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.audio import io as JIO
from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.data import dataset as JDS
from birdnet_stm32_tpu.data import species as JSP
from birdnet_stm32_tpu.evaluation.metrics import chunks_for_file as j_chunks_for_file
from birdnet_stm32_tpu.models import serving as J
from birdnet_stm32_tpu_torch.audio import io as PIO
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.data import dataset as PDS
from birdnet_stm32_tpu_torch.data import species as PSP
from birdnet_stm32_tpu_torch.evaluation.metrics import chunks_for_file
from birdnet_stm32_tpu_torch.models import serving as P
from tests.test_torch_cpu_warmup import warm_up

warm_up()

SR = 8000
CFG_KW = dict(sample_rate=SR, num_mels=32, spec_width=32, fft_length=256, chunk_duration=1.0)
# (bits, audio_format, channels) of each file written at the model rate.
FORMATS = [(8, 1, 1), (16, 1, 1), (24, 1, 1), (32, 1, 1), (32, 3, 1), (64, 3, 1),
           (8, 1, 2), (16, 1, 2), (24, 1, 2), (32, 1, 2), (32, 3, 2), (64, 3, 2)]


def _write_wav(path, x: np.ndarray, sr: int, bits: int, fmt: int, extensible: bool = False):
    """Write float [T, C] in [-1, 1] as a RIFF WAV of the given sample
    format (1 = PCM, 3 = IEEE float), optionally WAVE_FORMAT_EXTENSIBLE,
    with a LIST chunk before data (the walker must skip it)."""
    T, C = x.shape
    if fmt == 3:
        data = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        data = np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.clip(np.round(x * 8388607), -8388608, 8388607).astype("<i4")
        data = v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        full = {16: 32767, 32: 2147483647}[bits]
        v = np.clip(np.round(x.astype(np.float64) * full), -full - 1, full)
        data = v.astype("<i2" if bits == 16 else "<i4").tobytes()
    block = C * bits // 8
    if extensible:
        fmt_body = struct.pack("<HHIIHHHHI16s", 0xFFFE, C, sr, sr * block, block, bits, 22,
                               bits, 0, struct.pack("<H", fmt) + b"\x00" * 14)
    else:
        fmt_body = struct.pack("<HHIIHH", fmt, C, sr, sr * block, block, bits)
    extra = b"LIST" + struct.pack("<I", 5) + b"INFOx\x00"  # odd size, padded
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body + extra
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _signal(seed: int, T: int, C: int, peak: float = 0.7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(T) / SR
    x = 0.5 * np.sin(2 * np.pi * 440 * t)[:, None] + rng.normal(0, 0.1, (T, C))
    return (peak * x / np.abs(x).max()).astype(np.float32)


def _cfgs():
    return ModelConfig(**CFG_KW), JaxModelConfig(**CFG_KW)


@pytest.mark.parametrize("bits,fmt,ch", FORMATS, ids=lambda v: str(v))
def test_decode_bit_equal_at_model_rate(tmp_path, bits, fmt, ch):
    """wav_info, load_audio_file, chunks_for_file and decode_for_classify
    (float and mu-law) equal the JAX functions bit for bit."""
    path = tmp_path / f"f_{bits}_{fmt}_{ch}.wav"
    _write_wav(path, _signal(bits + ch, int(2.6 * SR), ch), SR, bits, fmt)
    assert astuple(PIO.wav_info(path)) == astuple(JIO.wav_info(path))
    cfg, jcfg = _cfgs()
    got = PIO.load_audio_file(path, sample_rate=SR, chunk_duration=1.0, chunk_overlap=0.25)
    ref = JIO.load_audio_file(path, sample_rate=SR, chunk_duration=1.0, chunk_overlap=0.25)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (4, SR)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(chunks_for_file(str(path), cfg), j_chunks_for_file(str(path), jcfg))
    for kw in ({}, {"ulaw_io": True}):
        c, rate, dur, _ = P.decode_for_classify(path, cfg, **kw)
        jc, jrate, jdur, _ = J.decode_for_classify(path, jcfg, **kw)
        assert c.dtype == jc.dtype and (rate, dur) == (jrate, jdur)
        np.testing.assert_array_equal(c, jc)


def test_extensible_header_and_streamed_size(tmp_path):
    """WAVE_FORMAT_EXTENSIBLE carries the format in its subformat; a data
    size past the end of the file (a streamed recording) is clamped."""
    path = tmp_path / "ext.wav"
    _write_wav(path, _signal(1, 3000, 2), SR, 24, 1, extensible=True)
    info = PIO.wav_info(path)
    assert (info.audio_format, info.bits, info.channels, info.frames) == (1, 24, 2, 3000)
    raw = bytearray(path.read_bytes())
    at = raw.index(b"data") + 4
    raw[at : at + 4] = struct.pack("<I", 0xFFFFFFFF)
    path.write_bytes(bytes(raw))
    assert astuple(PIO.wav_info(path)) == astuple(JIO.wav_info(path))
    assert PIO.wav_info(path).frames == 3000
    np.testing.assert_array_equal(PIO.load_audio_file(path, sample_rate=SR, chunk_duration=1.0),
                                  JIO.load_audio_file(path, sample_rate=SR, chunk_duration=1.0))


def test_int16_chunks_raw_codes(tmp_path):
    """load_chunks_int16 and the int16 decode equal the JAX ones: raw codes
    with the window peak in the scale column, -32768 encoding a peak of
    32768; dequantized they are the float decode, bit for bit."""
    cfg, jcfg = _cfgs()
    codes = np.round(_signal(2, int(2.3 * SR), 1)[:, 0] * 20000).astype(np.int16)
    for name, peak_code in (("mid.wav", None), ("full.wav", -32768)):
        c = codes.copy()
        if peak_code is not None:
            c[100] = peak_code
        path = tmp_path / name
        with wave_mod.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(c.astype("<i2").tobytes())
        got = PIO.load_chunks_int16(path, SR, chunk_duration=1.0)
        ref = JIO.load_chunks_int16(path, SR, chunk_duration=1.0)
        np.testing.assert_array_equal(got, ref)
        want_scale = -32768 if peak_code is not None else int(np.abs(c.astype(np.int32)).max())
        assert got.dtype == np.int16 and (got[:, -1] == want_scale).all()
        d, rate, _, _ = P.decode_for_classify(path, cfg, int16_io=True)
        np.testing.assert_array_equal(d, J.decode_for_classify(path, jcfg, int16_io=True)[0])
        np.testing.assert_array_equal(d, got)
        deq = P._dequantize_int16(torch.from_numpy(d)).numpy()
        np.testing.assert_array_equal(deq, P.decode_for_classify(path, cfg)[0])


@pytest.mark.parametrize("case", ["stereo", "other_rate", "pcm24", "not_wav"])
def test_int16_ineligible_files(tmp_path, case):
    """Not mono PCM16 at the decode rate: load_chunks_int16 returns None and
    the int16 decode requantizes the float decode, as in JAX."""
    cfg, jcfg = _cfgs()
    path = tmp_path / ("x.flac" if case == "not_wav" else "x.wav")
    bits, ch, sr = {"stereo": (16, 2, SR), "other_rate": (16, 1, 16000),
                    "pcm24": (24, 1, SR), "not_wav": (16, 1, SR)}[case]
    _write_wav(path, _signal(3, int(1.5 * sr), ch), sr, bits, 1)
    assert PIO.load_chunks_int16(path, SR) is None and JIO.load_chunks_int16(path, SR) is None
    got, _, _, _ = P.decode_for_classify(path, cfg, int16_io=True)
    ref, _, _, _ = J.decode_for_classify(path, jcfg, int16_io=True)
    if case == "not_wav":
        # A RIFF file named .flac: without the libav codec no chunks; with
        # it, the codec decodes it as the JAX package's does.
        from birdnet_stm32_tpu_torch.audio import native

        if not native.codec_available():
            assert got.shape == (0, SR + 1)
            return
        assert got.shape[0] > 0 and got.dtype == ref.dtype == np.int16
        np.testing.assert_array_equal(got, ref)
        return
    assert got.dtype == np.int16 and (got[:, -1] == 32767).all()
    if case == "other_rate":  # resampled floats, requantized: one code apart at most
        assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src_rate", [16000, 22050, 44100])
def test_decode_with_resample(tmp_path, src_rate):
    """A file at another rate: resampled on the host (within 2e-5 of JAX),
    or, with device_resample, decoded at its own rate (bit-equal)."""
    cfg, jcfg = _cfgs()
    path = tmp_path / "r.wav"
    _write_wav(path, _signal(4, int(2.2 * src_rate), 1), src_rate, 16, 1)
    got, rate, dur, _ = P.decode_for_classify(path, cfg)
    ref, jrate, jdur, _ = J.decode_for_classify(path, jcfg)
    assert (rate, dur) == (jrate, jdur) and rate == SR and dur == pytest.approx(2.2)
    assert got.shape == ref.shape == (3, SR)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    got, rate, _, _ = P.decode_for_classify(path, cfg, device_resample=True)
    ref, jrate, _, _ = J.decode_for_classify(path, jcfg, device_resample=True)
    assert rate == jrate == src_rate and got.shape == (3, src_rate)
    np.testing.assert_array_equal(got, ref)


def test_windows_offsets_and_chunking():
    """The window policy with a seeded random offset, chunk counts and
    chunk starts, against JAX."""
    for total, sr, max_dur in ((96000, SR, 5.0), (7000, SR, None), (50, SR, 3.0)):
        for seed in range(3):
            got = PIO._window_bounds(total, sr, max_dur, 3.0, True, np.random.default_rng(seed))
            ref = JIO._window_bounds(total, sr, max_dur, 3.0, True, np.random.default_rng(seed))
            assert got == ref
    for n in (0, 1, 7999, 8000, 8001, 20000, 31234):
        for ov in (0.0, 0.5, 0.95):
            assert PIO.estimate_num_chunks(n, SR, 1.0, ov) == JIO.estimate_num_chunks(n, SR, 1.0, ov)
            y = np.arange(n, dtype=np.float32)
            got = PIO.split_audio_into_chunks(y, SR, 1.0, ov)
            np.testing.assert_array_equal(got, JIO.split_audio_into_chunks(y, SR, 1.0, ov))
            assert got.shape[0] == PIO.estimate_num_chunks(n, SR, 1.0, ov)
            if n > SR:
                np.testing.assert_array_equal(PIO.chunk_starts(n, SR, 1.0, ov),
                                              JIO.chunk_starts(n, SR, 1.0, ov))


def test_random_offset_window_and_int16_window(tmp_path):
    path = tmp_path / "long.wav"
    PIO.save_wav(_signal(5, 9 * SR, 1)[:, 0], path, SR)
    for seed in range(3):
        got = PIO.load_audio_window(path, SR, max_duration=3.0, random_offset=True,
                                    rng=np.random.default_rng(seed))
        ref = JIO.load_audio_window(path, SR, max_duration=3.0, random_offset=True,
                                    rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            PIO.load_window_int16(path, SR, 3.0, random_offset=True, rng=np.random.default_rng(seed)),
            JIO.load_window_int16(path, SR, 3.0, random_offset=True, rng=np.random.default_rng(seed)))


def test_save_wav_bytes_and_bad_files(tmp_path):
    """save_wav writes JAX's bytes; undecodable files give no audio."""
    x = _signal(6, 5000, 1)[:, 0] * 1.3  # clipped at +-1
    PIO.save_wav(x, tmp_path / "p.wav", 22050)
    JIO.save_wav(x, tmp_path / "j.wav", 22050)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    bad = tmp_path / "garbage.wav"
    bad.write_bytes(b"RIFFnope" * 5)
    assert PIO.load_audio_file(bad, SR, chunk_duration=1.0).shape == (0, SR)
    cfg, _ = _cfgs()
    chunks, rate, dur, _ = P.decode_for_classify(bad, cfg)
    assert chunks.shape == (0, SR) and (rate, dur) == (SR, 0.0)
    with pytest.raises(ValueError):
        PIO.wav_info(bad)
    alaw = tmp_path / "alaw.wav"
    _write_wav(alaw, _signal(7, 800, 1), SR, 8, 1)
    raw = bytearray(alaw.read_bytes())
    raw[20:22] = struct.pack("<H", 6)  # a-law: not decoded
    alaw.write_bytes(bytes(raw))
    assert PIO.load_audio_file(alaw, SR, chunk_duration=1.0).shape == (0, SR)


def test_extensions_and_species_lists(tmp_path):
    assert PDS.AUDIO_EXTENSIONS == JDS.AUDIO_EXTENSIONS == (".wav",)
    # Compressed formats join where the libav codec is built, in both.
    assert PDS.supported_audio_extensions() == JDS.supported_audio_extensions()
    p = tmp_path / "species.txt"
    p.write_text("b sp\n\n  a sp \nb sp\nc sp\n", encoding="utf-8")
    assert PSP.load_species_list(p) == JSP.load_species_list(p)
    assert PSP.open_species_list(p) == JSP.open_species_list(p) == ["a sp", "b sp", "c sp"]
    empty = tmp_path / "empty.txt"
    empty.write_text("\n \n")
    with pytest.raises(ValueError, match="empty"):
        PSP.load_species_list(empty)
    with pytest.raises(FileNotFoundError):
        PSP.open_species_list(tmp_path / "missing.txt")
