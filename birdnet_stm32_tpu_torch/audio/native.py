"""ctypes bindings for the native host-side audio libraries (port of
audio/native.py).

Two libraries, built from the port's own copies of the JAX package's C++
sources (audio/csrc/) with g++ on first use, into `build/torch_native/` at
the repository root (the file names carry a digest of the source, the
flags and the host, so an edited source rebuilds and a copied tree never
loads another CPU's -march=native build):

- libaudio_native: the WAV reader (RIFF walk, PCM -> float32, mean
  downmix) and the polyphase resampler (scipy.signal.resample_poly's
  filter);
- libaudio_codec: mp3 / flac / ogg / m4a decode and encode over FFmpeg's
  libav* (pkg-config's flags), built only where pkg-config finds libav.

The flags are the JAX package's native/Makefile's, so both packages decode
the same samples. `available()` and `codec_available()` gate the callers
(audio/io.py): without a compiler the WAV path is the numpy reader, and
without libav a compressed file decodes to nothing, as in the JAX package.
Builds run under an exclusive file lock, so loader threads and spawn
workers that hit the first use together never load a half-written library.
Setting BIRDNET_TPU_TORCH_NO_NATIVE turns both libraries off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBAV = ("libavformat", "libavcodec", "libswresample", "libavutil")
NO_NATIVE_ENV = "BIRDNET_TPU_TORCH_NO_NATIVE"


def _libav_flags() -> list[str] | None:
    """pkg-config's compile and link flags for libav, or None without it."""
    if shutil.which("pkg-config") is None:
        return None
    proc = subprocess.run(["pkg-config", "--cflags", "--libs", *LIBAV],
                          capture_output=True, text=True, check=False)
    return proc.stdout.split() if proc.returncode == 0 else None


def library_path(name: str, extra: tuple[str, ...] = ()) -> Path:
    """Where libaudio_<name>'s build of the current source and flags lives
    on this host (-march=native code runs only where it was built, so the
    host's name is part of the digest)."""
    src = (CSRC_DIR / f"audio_{name}.cc").read_bytes()
    key = " ".join((*CXXFLAGS, *extra, platform.node(), platform.machine()))
    digest = hashlib.sha256(src + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libaudio_{name}-{digest}.so"


def _build_locked(name: str, extra: tuple[str, ...]) -> Path:
    """Build libaudio_<name> unless it exists, under a cross-process lock;
    raises on a failed build."""
    import fcntl

    so = library_path(name, extra)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not so.exists():  # another process may have built it
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
                     str(CSRC_DIR / f"audio_{name}.cc"), *extra],
                    capture_output=True, text=True, timeout=300, check=False)
                if proc.returncode != 0:
                    raise RuntimeError(f"building libaudio_{name} failed:\n{proc.stderr}")
                os.replace(tmp, so)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return so


class _Library:
    """One native library, loaded (building it first) on first use; a
    failed build or load is remembered for the life of the process."""

    def __init__(self, name: str, declare):
        self.name, self._declare = name, declare
        self._lib, self._failed = None, False
        self._lock = threading.Lock()
        self.error: str | None = None

    def get(self):
        if self._lib is not None or self._failed:
            return self._lib
        with self._lock:
            if self._lib is None and not self._failed:
                self._load()
        return self._lib

    def _load(self) -> None:
        if os.environ.get(NO_NATIVE_ENV):
            self._failed, self.error = True, f"{NO_NATIVE_ENV} is set"
            return
        extra = ()
        if self.name == "codec":
            flags = _libav_flags()
            if flags is None:
                self._failed, self.error = True, "pkg-config finds no libav"
                return
            extra = tuple(flags)
        try:
            lib = ctypes.CDLL(str(_build_locked(self.name, extra)))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            self._failed, self.error = True, f"{type(e).__name__}: {e}"
            return
        self._declare(lib)
        self._lib = lib


def _declare_native(lib) -> None:
    lib.wav_native_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    lib.wav_native_info.restype = ctypes.c_int
    lib.wav_native_read.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.wav_native_read.restype = ctypes.c_long
    lib.resample_poly_native.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.resample_poly_native.restype = ctypes.c_long


def _declare_codec(lib) -> None:
    lib.codec_audio_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    lib.codec_audio_info.restype = ctypes.c_int
    lib.codec_decode_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int)]
    lib.codec_decode_f32.restype = ctypes.c_long
    lib.codec_encode_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.c_int]
    lib.codec_encode_f32.restype = ctypes.c_int


NATIVE = _Library("native", _declare_native)
CODEC = _Library("codec", _declare_codec)


def available() -> bool:
    """True when the WAV reader and resampler library loaded (or could be
    built) here."""
    return NATIVE.get() is not None


def codec_available() -> bool:
    """True when the libav-backed codec library loaded (or could be built)
    here."""
    return CODEC.get() is not None


def _native():
    lib = NATIVE.get()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({NATIVE.error})")
    return lib


def _codec():
    lib = CODEC.get()
    if lib is None:
        raise RuntimeError(f"codec library unavailable ({CODEC.error})")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path: str | os.PathLike) -> tuple[int, int, int]:
    """(sample_rate, channels, frames) of a WAV file."""
    lib = _native()
    sr, ch, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    rc = lib.wav_native_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch),
                             ctypes.byref(fr))
    if rc != 0:
        raise ValueError(f"cannot parse WAV {path} (rc={rc})")
    return sr.value, ch.value, fr.value


def wav_read(path: str | os.PathLike, start_frame: int = 0, n_frames: int | None = None,
             downmix: bool = True) -> np.ndarray:
    """Decode a frame window to mono float32 (the C decode loop)."""
    lib = _native()
    if n_frames is None:
        _, _, total = wav_info(path)
        n_frames = total - start_frame
    out = np.empty(max(0, n_frames), np.float32)
    got = lib.wav_native_read(str(path).encode(), start_frame, n_frames, int(downmix),
                              _fptr(out))
    if got < 0:
        raise ValueError(f"cannot decode WAV {path} (rc={got})")
    return out[:got]


def resample_poly(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample matching scipy.signal.resample_poly(x, up, down)."""
    lib = _native()
    from math import gcd

    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    x = np.ascontiguousarray(x, np.float32)
    if up == down:
        return x
    out = np.empty(-(-len(x) * up // down), np.float32)
    got = lib.resample_poly_native(_fptr(x), len(x), up, down, _fptr(out))
    return out[:got]


def codec_info(path: str | os.PathLike) -> tuple[int, int, int]:
    """(sample_rate, channels, approximate frames) of any supported audio
    file."""
    lib = _codec()
    sr, ch, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    rc = lib.codec_audio_info(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch),
                              ctypes.byref(fr))
    if rc != 0:
        raise ValueError(f"cannot probe audio file: {path}")
    return sr.value, ch.value, fr.value


def codec_decode(path: str | os.PathLike, offset_frames: int = 0,
                 max_frames: int = 0) -> tuple[np.ndarray, int]:
    """(mono float32 at the native rate, sample_rate): the channel mean,
    from `offset_frames`, `max_frames` long (<= 0: to the end)."""
    lib = _codec()
    if max_frames and max_frames > 0:
        # A window read: the cap is the request, and the decoder opens the
        # file itself, so no probe is paid.
        cap = int(max_frames)
    else:
        sr, _, frames = codec_info(path)
        cap = max(frames, sr) + sr
    sr_out = ctypes.c_int()
    while True:
        out = np.empty(cap + 4096, np.float32)
        n = lib.codec_decode_f32(str(path).encode(), int(offset_frames), int(max_frames),
                                 _fptr(out), len(out), ctypes.byref(sr_out))
        if n < 0:
            raise ValueError(f"decode failed for {path}")
        # The container's duration can undercount (VBR mp3 without a Xing
        # header): a whole-file decode that fills the buffer may be cut, so
        # it retries with twice the room until it stops short.
        if n < len(out) or (max_frames and max_frames > 0):
            return out[:n].copy(), sr_out.value
        cap *= 2


def codec_encode(path: str | os.PathLike, data: np.ndarray, sample_rate: int) -> None:
    """Encode mono float32 to .flac / .ogg / .mp3 / .m4a / .wav by the
    extension."""
    lib = _codec()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    x = np.ascontiguousarray(data, np.float32)
    rc = lib.codec_encode_f32(str(path).encode(), _fptr(x), len(x), int(sample_rate))
    if rc != 0:
        raise ValueError(f"encode failed for {path} (rc={rc})")
