"""WAV loading, resampling, chunking and saving (port of audio/io.py).

A RIFF reader on numpy memmaps (chunk walker, PCM 8/16/24/32-bit and
float32/64 to float32, mono downmix by the mean), the JAX package's window
policy, peak normalisation, polyphase resampling with
`scipy.signal.resample_poly`, and overlap-aware chunking with a zero-padded
tail. Any decode error returns an empty array, as in the JAX package.

The JAX package decodes and resamples through its native library when it
is built and falls back to this numpy code; the port has only the numpy
code. Not ported (ROADMAP.md): compressed formats (the libav codec). A
compressed file is a content miss everywhere: an empty array, and in the
decoded-waveform cache a miss that is not persisted, as in the JAX package
when its codec is absent.

The decoded-waveform cache (`cache_dir=`, `cached_waveform`): the whole
file is decoded, downmixed and resampled to the target rate once, stored as
an .npy under a key of path, mtime_ns, size and rate (the JAX package's
key), published by atomic rename, and later calls slice their window out of
a read-only memmap.
"""

from __future__ import annotations

import os
import struct
import wave
from dataclasses import dataclass
from math import gcd
from pathlib import Path

import numpy as np


@dataclass
class WavInfo:
    """Parsed RIFF header: enough to do windowed reads."""

    path: str
    sample_rate: int
    channels: int
    bits: int
    audio_format: int  # 1 = PCM, 3 = IEEE float
    data_offset: int
    data_bytes: int

    @property
    def frames(self) -> int:
        bytes_per_frame = self.channels * (self.bits // 8)
        return self.data_bytes // bytes_per_frame if bytes_per_frame else 0


def wav_info(path: str | Path) -> WavInfo:
    """Walk the RIFF chunks to locate fmt and data."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                body = f.read(size + (size & 1))  # RIFF chunks pad to even
                audio_format, channels, rate = struct.unpack("<HHI", body[:8])
                bits = struct.unpack("<H", body[14:16])[0]
                if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    audio_format = struct.unpack("<H", body[24:26])[0]
                fmt = (audio_format, channels, rate, bits)
            elif cid == b"data":
                if fmt is None:
                    raise ValueError(f"data chunk before fmt in {path}")
                # Streamed or interrupted recorders write size 0xFFFFFFFF (or
                # more than was flushed): clamp to the bytes on disk.
                data_offset = f.tell()
                on_disk = max(0, os.fstat(f.fileno()).st_size - data_offset)
                return WavInfo(str(path), fmt[2], fmt[1], fmt[3], fmt[0],
                               data_offset, min(size, on_disk))
            else:
                f.seek(size + (size & 1), 1)
        raise ValueError(f"no data chunk in {path}")


def _decode_frames(info: WavInfo, start_frame: int, n_frames: int) -> np.ndarray:
    """Read and decode [n_frames, channels] float32 in [-1, 1]."""
    # a-law / mu-law (format 6/7) 8-bit data would otherwise decode through
    # the unsigned-PCM branch as garbage.
    supported = ((info.audio_format == 3 and info.bits in (32, 64))
                 or (info.audio_format == 1 and info.bits in (8, 16, 24, 32)))
    if not supported:
        raise ValueError(f"unsupported WAV bits={info.bits} format={info.audio_format}")
    bytes_per_frame = info.bits // 8 * info.channels
    n_frames = max(0, min(n_frames, info.frames - start_frame))
    if n_frames <= 0:
        return np.empty((0, info.channels), np.float32)
    raw = np.memmap(info.path, dtype=np.uint8, mode="r",
                    offset=info.data_offset + start_frame * bytes_per_frame,
                    shape=(n_frames * bytes_per_frame,))
    if info.audio_format == 3:  # IEEE float
        y = np.frombuffer(raw, dtype=np.float32 if info.bits == 32 else np.float64)
        y = y.astype(np.float32)
    elif info.bits == 16:
        y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif info.bits == 32:
        y = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif info.bits == 8:
        y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:  # 24
        b = raw.reshape(-1, 3).astype(np.uint32)
        v = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)).astype(np.int32)
        v = (v << 8) >> 8  # sign extend
        y = v.astype(np.float32) / 8388608.0
    return y.reshape(n_frames, info.channels)


def fast_resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling with scipy.signal.resample_poly."""
    if sr_in == sr_out:
        return y.astype(np.float32, copy=False)
    # Imported here: scipy.signal takes seconds to import, and the loader's
    # spawn workers import this module whether or not they resample.
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(y, sr_out // g, sr_in // g).astype(np.float32, copy=False)


def estimate_num_chunks(num_samples: int, sample_rate: int, chunk_duration: float,
                        chunk_overlap: float = 0.0) -> int:
    """Chunk count that split_audio_into_chunks would emit."""
    chunk_size = int(sample_rate * chunk_duration)
    if num_samples <= 0 or chunk_size <= 0:
        return 0
    if num_samples <= chunk_size:
        return 1
    max_overlap = max(0.0, min(chunk_overlap, chunk_duration - 0.1))
    step = max(1, int(sample_rate * (chunk_duration - max_overlap)))
    n_full = 1 + max(0, (num_samples - chunk_size) // step)
    has_tail = (num_samples - chunk_size) % step != 0
    return int(n_full + int(has_tail))


def _window_bounds(total_frames: int, sr: int, max_duration, chunk_duration,
                   random_offset, rng) -> tuple[int, int]:
    """(start_frame, n_frames) of the read window.

    read_duration = min(max_duration, total); a random offset is drawn in
    [0, total - max(chunk_duration, read_duration)] seconds. Returns n <= 0
    when there is nothing to read.
    """
    total_duration = total_frames / float(sr)
    read_duration = (min(float(max_duration), total_duration)
                     if max_duration and max_duration > 0 else total_duration)
    offset_sec = 0.0
    if random_offset:
        max_start = max(0.0, total_duration - max(chunk_duration, read_duration))
        if max_start > 0:
            r = (rng.uniform(0.0, max_start) if rng is not None
                 else np.random.uniform(0.0, max_start))
            offset_sec = float(r)
    start = min(int(offset_sec * sr), total_frames)
    n = int(min(total_frames - start, read_duration * sr))
    return start, n


def load_audio_window(
    path: str | Path,
    sample_rate: int = 24000,
    max_duration: float | None = 30,
    chunk_duration: float = 3.0,
    random_offset: bool = False,
    rng: np.random.Generator | None = None,
    cache_dir: str | Path | None = None,
) -> np.ndarray:
    """One contiguous mono window of a WAV: read -> downmix -> resample ->
    peak-normalise. Returns an empty array on any error and for files that
    are not WAV.

    cache_dir serves the window from the decoded-waveform cache
    (cached_waveform), with the same offset, duration and peak policy; the
    random offset is still drawn per call, only the decode is cached.
    """
    try:
        if cache_dir is not None:
            return _load_window_cached(path, sample_rate, max_duration, chunk_duration,
                                       random_offset, rng, cache_dir)
        if Path(path).suffix.lower() != ".wav":
            return np.empty((0,), np.float32)
        info = wav_info(path)
        if info.frames <= 0 or info.sample_rate <= 0:
            return np.empty((0,), np.float32)
        sr0 = info.sample_rate
        start, n = _window_bounds(info.frames, sr0, max_duration, chunk_duration,
                                  random_offset, rng)
        if n <= 0:
            return np.empty((0,), np.float32)
        frames = _decode_frames(info, start, n)
        if frames.size == 0:
            return np.empty((0,), np.float32)
        y = frames.mean(axis=1).astype(np.float32, copy=False)
        if sr0 != sample_rate:
            y = fast_resample(y, sr0, sample_rate)
        peak = float(np.max(np.abs(y))) if y.size else 0.0
        if peak > 0.0:
            y = y / peak
        return y.astype(np.float32, copy=False)
    except Exception:
        return np.empty((0,), np.float32)


def _cache_key(path: Path, sample_rate: int) -> str:
    """Cache entry name: sha1 of the resolved path, mtime_ns, size and rate
    (the JAX package's string). A rewritten file is a miss; the stale entry
    is never read again, so nothing needs invalidating."""
    import hashlib

    st = path.stat()
    raw = f"{path.resolve()}|{st.st_mtime_ns}|{st.st_size}|{sample_rate}"
    return hashlib.sha1(raw.encode()).hexdigest()


def cached_waveform(path: str | Path, sample_rate: int, cache_dir: str | Path) -> np.ndarray:
    """The whole decoded mono waveform at `sample_rate`, through the .npy
    cache.

    A hit returns a read-only memmap. A miss decodes the whole WAV,
    downmixes and resamples it, and publishes the entry by an atomic
    rename, so concurrent workers never see a torn file. A content failure
    (an unparseable or empty file) is cached as an empty array; an OSError
    or MemoryError is not persisted and returns empty for this call only.
    A compressed file is a content miss that is not persisted: the port has
    no codec, as the JAX package when its codec is not built.
    """
    path = Path(path)
    cache_dir = Path(cache_dir)
    entry = cache_dir / f"{_cache_key(path, sample_rate)}.npy"
    if entry.exists():
        try:
            return np.load(entry, mmap_mode="r")
        except Exception:
            pass  # torn or corrupt entry: rebuild it

    y = np.empty((0,), np.float32)
    if path.suffix.lower() != ".wav":
        return y
    try:
        info = wav_info(path)
        if info.frames > 0 and info.sample_rate > 0:
            y = _decode_frames(info, 0, info.frames).mean(axis=1).astype(np.float32, copy=False)
            if y.size and info.sample_rate != sample_rate:
                y = fast_resample(y, info.sample_rate, sample_rate)
    except (OSError, MemoryError):
        return np.empty((0,), np.float32)  # environmental: retry next call
    except Exception:
        y = np.empty((0,), np.float32)

    y = np.ascontiguousarray(y, dtype=np.float32)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = cache_dir / f"{entry.stem}.{os.getpid()}.tmp.npy"
    try:
        with open(tmp, "wb") as f:
            np.save(f, y)
        os.replace(tmp, entry)
    except Exception:
        tmp.unlink(missing_ok=True)
    return y


# Files whose whole decode (at the source or the target rate, all channels,
# float32) would exceed this many bytes take the direct window path instead
# of the cache, so a worker never holds hours of decoded audio: 512 MB is
# ~100 min at 22.05 kHz.
CACHE_MAX_DECODED_BYTES = 512 * 1024 * 1024


def _load_window_cached(path, sample_rate, max_duration, chunk_duration, random_offset,
                        rng, cache_dir) -> np.ndarray:
    """load_audio_window over the decoded-waveform cache: the same window
    policy (_window_bounds) and peak normalisation, applied at the target
    rate. The only difference from the direct path is that a resampled
    file was resampled whole, which moves a few samples at the window's
    edges (the polyphase filter's ramp)."""
    entry = Path(cache_dir) / f"{_cache_key(Path(path), sample_rate)}.npy"
    if not entry.exists():
        # Probe before the whole decode: too-long files are not cached.
        try:
            info = audio_info(path)
            frames_at_target = info.frames / max(info.sample_rate, 1) * sample_rate
            # The decode materialises [frames, channels] float32 before the
            # downmix, so channels count against the cap.
            ch = max(1, info.channels)
            if 4 * max(info.frames * ch, frames_at_target) > CACHE_MAX_DECODED_BYTES:
                return load_audio_window(path, sample_rate, max_duration, chunk_duration,
                                         random_offset, rng)
        except Exception:
            pass  # unparseable: cached_waveform caches it as empty
    y_full = cached_waveform(path, sample_rate, cache_dir)
    total_frames = int(y_full.shape[0])
    if total_frames <= 0:
        return np.empty((0,), np.float32)
    start, n = _window_bounds(total_frames, sample_rate, max_duration, chunk_duration,
                              random_offset, rng)
    if n <= 0:
        return np.empty((0,), np.float32)
    # A copy: callers get a writable array even on a memmap hit.
    y = np.array(y_full[start : start + n], dtype=np.float32)
    peak = float(np.max(np.abs(y))) if y.size else 0.0
    if peak > 0.0:
        y /= peak
    return y


def audio_info(path: str | Path) -> WavInfo:
    """Header probe of a supported audio file (WAV only in the port)."""
    p = Path(path)
    if p.suffix.lower() != ".wav":
        raise ValueError(f"only WAV files are decoded by the port: {path}")
    return wav_info(p)


def split_audio_into_chunks(
    audio: np.ndarray,
    sample_rate: int = 24000,
    chunk_duration: float = 3.0,
    chunk_overlap: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """[T] -> [num_chunks, chunk_size]; short input is zero-padded once;
    a shifted tail chunk covers the remainder.

    dtype=np.int16 chunks raw PCM codes without a float round trip
    (load_chunks_int16)."""
    chunk_size = int(sample_rate * chunk_duration)
    if audio.size == 0 or chunk_size <= 0:
        return np.empty((0, max(chunk_size, 0)), dtype)
    y = np.asarray(audio, dtype).reshape(-1)
    if y.shape[0] <= chunk_size:
        return np.pad(y, (0, chunk_size - y.shape[0]))[None, :]
    starts = chunk_starts(y.shape[0], sample_rate, chunk_duration, chunk_overlap)
    return np.stack([y[s : s + chunk_size] for s in starts])


def chunk_starts(n: int, sample_rate: int, chunk_duration: float,
                 chunk_overlap: float = 0.0) -> np.ndarray:
    """Start offsets split_audio_into_chunks slices at, for an input of
    length n > chunk_size."""
    chunk_size = int(sample_rate * chunk_duration)
    max_overlap = max(0.0, min(chunk_overlap, chunk_duration - 0.1))
    step = max(1, int(sample_rate * (chunk_duration - max_overlap)))
    starts = np.arange(0, n - chunk_size + 1, step, dtype=np.int64)
    if starts.size == 0 or starts[-1] + chunk_size < n:
        starts = np.append(starts, n - chunk_size)
    return starts


def load_audio_file(
    path: str | Path,
    sample_rate: int = 24000,
    max_duration: float = 30,
    chunk_duration: float = 3.0,
    chunk_overlap: float = 0.0,
    random_offset: bool = False,
    cache_dir: str | Path | None = None,
) -> np.ndarray:
    """Load + resample + normalise + chunk: [n_chunks, chunk_size] float32.
    cache_dir routes the decode through the decoded-waveform cache."""
    audio = load_audio_window(path, sample_rate=sample_rate, max_duration=max_duration,
                              chunk_duration=chunk_duration, random_offset=random_offset,
                              cache_dir=cache_dir)
    if audio.size == 0:
        return np.empty((0, int(sample_rate * chunk_duration)), np.float32)
    return split_audio_into_chunks(audio, sample_rate=sample_rate,
                                   chunk_duration=chunk_duration, chunk_overlap=chunk_overlap)


def load_chunks_int16(
    path: str | Path,
    sample_rate: int,
    chunk_duration: float = 3.0,
    chunk_overlap: float = 0.0,
    max_duration: float | None = None,
) -> np.ndarray | None:
    """Raw PCM16 codes for exactness-preserving int16 waveform shipping.

    For mono PCM16 WAV files already at `sample_rate`, returns
    [n_chunks, chunk_size + 1] int16: each row is the file's raw sample
    codes plus one trailing scale element holding the read window's peak
    code (-32768 encodes a peak of 32768, which int16 cannot hold). The
    device dequant (models/serving.py::_dequantize_int16) divides codes by
    |scale| with IEEE float32 division, which reproduces load_audio_window's
    floats bit for bit: c/32768 and peak/32768 are exact, so the host's
    (c/32768)/(peak/32768) and the device's c/peak round the same quotient.

    Returns None when the file is ineligible (not WAV, not mono PCM16, or
    another rate); callers then decode to float and requantize
    (quantize_waveform_int16).
    """
    try:
        codes = load_window_int16(path, sample_rate, max_duration=max_duration,
                                  chunk_duration=chunk_duration)
        if codes is None:
            return None
        # int32 before abs: |int16 -32768| overflows back to -32768.
        peak = int(np.max(np.abs(codes.astype(np.int32))))
        chunks = split_audio_into_chunks(codes, sample_rate=sample_rate,
                                         chunk_duration=chunk_duration,
                                         chunk_overlap=chunk_overlap, dtype=np.int16)
        scale = np.full((chunks.shape[0], 1), peak if peak < 32768 else -32768, np.int16)
        return np.concatenate([chunks, scale], axis=1)
    except Exception:
        return None


def load_window_int16(
    path: str | Path,
    sample_rate: int,
    max_duration: float | None = None,
    chunk_duration: float = 3.0,
    random_offset: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray | None:
    """Raw PCM16 codes of one read window, with load_audio_window's window
    policy (and rng draw order). None when the file is ineligible for exact
    int16 shipping: not WAV, not mono PCM16, another rate, or empty."""
    try:
        p = Path(path)
        if p.suffix.lower() != ".wav":
            return None
        info = wav_info(p)
        if not (info.audio_format == 1 and info.bits == 16 and info.channels == 1
                and info.sample_rate == sample_rate and info.frames > 0):
            return None
        start, n = _window_bounds(info.frames, info.sample_rate, max_duration,
                                  chunk_duration, random_offset, rng)
        if n <= 0:
            return None
        raw = np.memmap(p, dtype=np.uint8, mode="r",
                        offset=info.data_offset + start * 2, shape=(n * 2,))
        return np.frombuffer(raw, dtype="<i2")
    except Exception:
        return None


def save_wav(audio: np.ndarray, path: str | Path, sample_rate: int = 24000) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM WAV."""
    y = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (y * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
