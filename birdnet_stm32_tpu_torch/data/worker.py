"""The worker half of the training input pipeline (port of data/worker.py):
one file -> its top-ranked waveform chunks, as float32 rows, int16
raw-code rows or mu-law rows.

numpy only (no torch): pool workers start with the `spawn` context and
import just this module's graph (numpy and audio/; scipy only to
resample). Bit-equal to the JAX package's worker on WAV files.

Not ported: the decoded-waveform cache (`cache_dir`, the JAX package's
audio/io.cached_waveform); setting it raises.
"""

from __future__ import annotations

import signal
from dataclasses import dataclass

import numpy as np

from birdnet_stm32_tpu_torch.audio.activity import smart_crop, sort_by_activity
from birdnet_stm32_tpu_torch.audio.io import (
    chunk_starts,
    estimate_num_chunks,
    load_audio_window,
    load_window_int16,
    split_audio_into_chunks,
)


@dataclass
class LoaderConfig:
    """Picklable worker configuration.

    snr_threshold is the activity-ratio threshold on waveform chunks.
    ship_int16 ships [T+1] int16 rows (codes + scale column, half the
    float32 bytes): mono PCM16 WAVs at the model rate ship their raw codes
    (bit-exact after the batcher's dequant), everything else requantizes
    (one PCM16 LSB). ship_ulaw ships [T] int8 mu-law rows (a quarter of the
    bytes, ~2.2 % relative waveform error). The two are exclusive.
    cache_dir serves the float decode from the decoded-waveform cache
    (audio/io.py::cached_waveform); raw PCM16 codes are read directly.
    """

    sample_rate: int = 24000
    chunk_duration: float = 3.0
    num_classes: int = 0
    max_chunks_per_file: int = 2
    candidate_chunks_per_file: int | None = None
    snr_threshold: float = 0.1
    random_offset: bool = True
    load_duration: float | None = 30.0
    seed: int = 0
    cache_dir: str | None = None
    ship_int16: bool = False
    ship_ulaw: bool = False

    def resolved_candidates(self) -> int:
        if self.candidate_chunks_per_file is not None:
            return self.candidate_chunks_per_file
        return min(8, max(4, self.max_chunks_per_file * 2))


_ULAW_MU = 255.0
_ULAW_LOG1P_MU = float(np.log1p(_ULAW_MU))
_ULAW_SCALE = np.float32(127.0 / _ULAW_LOG1P_MU)


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float waveform -> int8 mu-law codes in [-127, 127]
    (mu = 255, the G.711 companding curve on a symmetric 8-bit grid).
    Inverse: models/serving._dequantize_ulaw (on the device); the round
    trip is off by at most half a companded step, ~2.2 % relative at every
    amplitude."""
    m = np.abs(x)
    np.minimum(m, np.float32(1.0), out=m)
    m *= np.float32(_ULAW_MU)
    np.log1p(m, out=m)
    m *= _ULAW_SCALE
    np.rint(m, out=m)
    return np.copysign(m, x).astype(np.int8)


def _ulaw_rows(rows):
    """[(chunk f32 [T], label)] -> [([T] int8 mu-law codes, label)]."""
    return [(ulaw_encode(x), lab) for x, lab in rows]


def _int16_row(codes: np.ndarray, T: int, scale: int) -> np.ndarray:
    """[<=T] int16 codes -> [T+1] row: zero-padded codes + scale column."""
    row = np.zeros(T + 1, np.int16)
    row[: codes.shape[0]] = codes
    row[T] = scale
    return row


def _select_from_raw_codes(path, cfg, rng, T):
    """The raw-PCM16 read and chunk selection of the compressed feeds.

    Reads the window's raw codes and rebuilds the float signal the float
    path would produce (c / 32768, then peak-normalised, in numpy float32)
    so the chunks selected are the float feed's. Returns (codes, y, starts,
    keep, peak), or None when the file is not a mono PCM16 WAV at the model
    rate and the caller must decode it as float.
    """
    codes = load_window_int16(
        path, cfg.sample_rate, max_duration=cfg.load_duration,
        chunk_duration=cfg.chunk_duration, random_offset=cfg.random_offset,
        rng=rng)
    if codes is None or codes.size == 0:
        return None
    # int32 before abs: |int16 -32768| overflows back to -32768.
    peak = int(np.max(np.abs(codes.astype(np.int32))))
    y = codes.astype(np.float32) / 32768.0
    if peak > 0:
        y = y / (peak / 32768.0)
    n_candidates = cfg.resolved_candidates()
    if estimate_num_chunks(y.shape[0], cfg.sample_rate, cfg.chunk_duration) > n_candidates:
        fchunks, starts = smart_crop(y, cfg.sample_rate, cfg.chunk_duration,
                                     max_chunks=n_candidates, return_starts=True)
    else:
        fchunks = list(split_audio_into_chunks(y, cfg.sample_rate, cfg.chunk_duration))
        starts = ([-1] if y.shape[0] <= T
                  else chunk_starts(y.shape[0], cfg.sample_rate,
                                    cfg.chunk_duration).tolist())
    if not fchunks:
        return None
    keep = sort_by_activity(fchunks, threshold=cfg.snr_threshold,
                            return_indices=True)[: cfg.max_chunks_per_file]
    return codes, y, starts, keep, peak


def _process_file_int16_exact(path, label, cfg, rng, T):
    """int16 rows of the raw PCM codes at the chunks the float feed selects;
    None when the file is ineligible."""
    sel = _select_from_raw_codes(path, cfg, rng, T)
    if sel is None:
        return None
    codes, _, starts, keep, peak = sel
    scale = peak if peak < 32768 else -32768
    lab = label.astype(np.float32)
    out = []
    for i in keep:
        s = starts[i]
        c = codes[:T] if s < 0 else codes[s : s + T]
        out.append((_int16_row(c, T, scale), lab))
    return out


def _process_file_ulaw_fast(path, label, cfg, rng, T):
    """mu-law rows of the float feed's chunks, through the raw-code read
    (no generic float decode); None when the file is ineligible."""
    sel = _select_from_raw_codes(path, cfg, rng, T)
    if sel is None:
        return None
    _, y, starts, keep, _ = sel
    lab = label.astype(np.float32)
    out = []
    for i in keep:
        s = starts[i]
        c = y[:T] if s < 0 else y[s : s + T]
        if c.shape[0] < T:
            c = np.pad(c, (0, T - c.shape[0]))
        out.append((ulaw_encode(c), lab))
    return out


def _requantize_rows(rows, T):
    """Float fallback of int16 shipping: [(chunk f32 [T], label)] ->
    [([T+1] int16, label)] with the scale column 32767 (one PCM16 LSB)."""
    out = []
    for x, lab in rows:
        codes = np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)
        out.append((_int16_row(codes, T, 32767), lab))
    return out


def process_file(task: tuple[str, np.ndarray, LoaderConfig, int]):
    """One file -> list of (waveform chunk [T] float32, label [C]); with
    cfg.ship_int16 the chunks are [T+1] int16 rows, with cfg.ship_ulaw [T]
    int8 mu-law rows.

    The file's numpy generator is seeded with cfg.seed + salt. A file that
    fails to load gives one uniform-noise chunk with an all-zero label.
    """
    path, label, cfg, salt = task
    if cfg.ship_int16 and cfg.ship_ulaw:
        raise ValueError("ship_int16 and ship_ulaw are mutually exclusive")
    rng = np.random.default_rng((cfg.seed + salt) & 0xFFFFFFFF)
    T = int(cfg.sample_rate * cfg.chunk_duration)
    if cfg.ship_int16:
        exact = _process_file_int16_exact(path, label, cfg, rng, T)
        if exact is not None:
            return exact
    if cfg.ship_ulaw:
        fast = _process_file_ulaw_fast(path, label, cfg, rng, T)
        if fast is not None:
            return fast
    audio = load_audio_window(
        path, sample_rate=cfg.sample_rate, max_duration=cfg.load_duration,
        chunk_duration=cfg.chunk_duration, random_offset=cfg.random_offset, rng=rng,
        cache_dir=cfg.cache_dir)

    if audio.size == 0:
        chunk = rng.uniform(-1.0, 1.0, T).astype(np.float32)
        # The zero label takes the caller's width (cfg.num_classes may be
        # unset when the loader was built straight from a label matrix).
        width = np.asarray(label).shape[-1] if label is not None else cfg.num_classes
        noise = [(chunk, np.zeros(width, np.float32))]
        if cfg.ship_int16:
            return _requantize_rows(noise, T)
        return _ulaw_rows(noise) if cfg.ship_ulaw else noise

    n_candidates = cfg.resolved_candidates()
    if estimate_num_chunks(audio.shape[0], cfg.sample_rate, cfg.chunk_duration) > n_candidates:
        chunks = smart_crop(audio, cfg.sample_rate, cfg.chunk_duration, max_chunks=n_candidates)
    else:
        chunks = list(split_audio_into_chunks(audio, cfg.sample_rate, cfg.chunk_duration))
    if not chunks:
        return None

    # Activity-rank (keeping at least one) and take the top max_chunks.
    selected = sort_by_activity(chunks, threshold=cfg.snr_threshold)[: cfg.max_chunks_per_file]

    out = []
    for c in selected:
        x = c[:T]
        if x.shape[0] < T:
            x = np.pad(x, (0, T - x.shape[0]))
        out.append((x.astype(np.float32), label.astype(np.float32)))
    if cfg.ship_int16:
        return _requantize_rows(out, T)
    return _ulaw_rows(out) if cfg.ship_ulaw else out


def process_files(tasks: list) -> list:
    """Pool entry: several files per task, to amortise dispatch."""
    out = []
    for task in tasks:
        result = process_file(task)
        if result:
            out.extend(result)
    return out


def worker_init():
    signal.signal(signal.SIGINT, signal.SIG_IGN)
