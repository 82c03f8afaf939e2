"""Activity detection, smart cropping and activity ranking (port of
audio/activity.py).

numpy only, a copy of the JAX package's module: the data-loader workers run
these on the host over variable-length recordings before batching.
"""

from __future__ import annotations

import numpy as np


def short_time_energy(audio: np.ndarray, frame_length: int = 1024, hop_length: int = 512) -> np.ndarray:
    """Per-frame mean-square energy (reference activity.py:12-30), O(n)
    memory. (A gathered [n_frames, frame_length] index matrix costs ~GBs
    per decode worker on hour-long soundscapes — exactly the recordings
    smart_crop exists for.)

    Hot path (frame_length == 2*hop_length — smart_crop's geometry): frame
    k is exactly hop-blocks k and k+1, so per-block sums of squares give
    every frame sum with no length-n float64 intermediate. The f64 cumsum
    the general path needs (f32 loses ~2-3 digits over 10^8 samples,
    enough to flip percentile thresholds) wrote 8 bytes/sample and was the
    single largest cost in the decode worker (profiled: 3.1 of 9.2 ms per
    30-s file); block sums accumulate f64 only across blocks — per-block
    f32 summation over <=2^11 unit-scale samples is ~1e-7-accurate, far
    inside the percentile threshold's tolerance.
    """
    n = audio.shape[0]
    n_frames = max(1, 1 + max(0, n - frame_length) // hop_length)
    starts = np.arange(n_frames) * hop_length
    ends = np.minimum(starts + frame_length, n)
    # Frames that run past the end are shorter in the reference (mean over
    # fewer samples).
    counts = np.maximum(ends - starts, 1)
    if frame_length == 2 * hop_length and n >= frame_length:
        n_blocks = n_frames + 1
        x = audio[: n_blocks * hop_length].astype(np.float32, copy=False)
        sq = x * x
        if sq.shape[0] < n_blocks * hop_length:
            sq = np.pad(sq, (0, n_blocks * hop_length - sq.shape[0]))
        bs = sq.reshape(n_blocks, hop_length).sum(axis=1, dtype=np.float64)
        return ((bs[:-1] + bs[1:]) / counts).astype(np.float32)
    cs = np.concatenate([[0.0], np.cumsum(np.square(audio, dtype=np.float64))])
    return ((cs[ends] - cs[starts]) / counts).astype(np.float32)


def smart_crop(
    audio: np.ndarray,
    sample_rate: int,
    chunk_duration: float,
    max_chunks: int = 5,
    energy_percentile: float = 75.0,
    return_starts: bool = False,
):
    """Extract the most salient chunks from a long recording.

    STE percentile threshold -> contiguous active regions -> one chunk
    centered on each region's energy peak -> dedup by half-chunk distance ->
    energy-ranked top max_chunks (reference activity.py:33-129).

    return_starts=True additionally returns each chunk's start offset into
    `audio` (-1 for the one short-input case, which zero-pads), so callers
    can slice the SAME windows out of a parallel array (the int16 shipping
    path slices raw PCM codes at the starts chosen on the float signal).
    """
    def _done(chunks, starts):
        return (chunks, starts) if return_starts else chunks

    chunk_size = int(sample_rate * chunk_duration)
    n = audio.shape[0]
    if n <= chunk_size:
        return _done(
            [np.pad(audio, (0, max(0, chunk_size - n)))[:chunk_size].astype(np.float32)],
            [-1])

    frame_len = min(1024, chunk_size // 4)
    hop = frame_len // 2
    ste = short_time_energy(audio, frame_length=frame_len, hop_length=hop)

    if ste.max() < 1e-10:
        mid = n // 2
        start = max(0, mid - chunk_size // 2)
        return _done([audio[start : start + chunk_size].astype(np.float32)], [start])

    above = ste >= np.percentile(ste, energy_percentile)
    # Contiguous region boundaries via diff of the boolean mask.
    padded = np.concatenate([[False], above, [False]])
    edges = np.flatnonzero(np.diff(padded.astype(np.int8)))
    regions = list(zip(edges[0::2], edges[1::2]))
    if not regions:
        mid = n // 2
        start = max(0, mid - chunk_size // 2)
        return _done([audio[start : start + chunk_size].astype(np.float32)], [start])

    candidates = []
    for rs, re in regions:
        peak_frame = rs + int(np.argmax(ste[rs:re]))
        peak_sample = peak_frame * hop
        start = max(0, min(peak_sample - chunk_size // 2, n - chunk_size))
        candidates.append((float(ste[peak_frame]), start))

    candidates.sort(key=lambda c: c[0], reverse=True)
    selected: list[int] = []
    for _e, start in candidates:
        if any(abs(start - s) < chunk_size // 2 for s in selected):
            continue
        selected.append(start)
        if len(selected) >= max_chunks:
            break
    if not selected:
        return _done([audio[:chunk_size].astype(np.float32)], [0])
    return _done([audio[s : s + chunk_size].astype(np.float32) for s in selected],
                 selected)


def get_s2n(x: np.ndarray) -> float:
    """mean/std SNR proxy (reference activity.py:132-157)."""
    return float(np.mean(x) / (np.std(x) + 1e-10))


# The reference spells the identical computation twice, by input kind
# (activity.py:130-156); keep both names importable.
get_s2n_from_spectrogram = get_s2n
get_s2n_from_audio = get_s2n


def sort_by_s2n(samples: list[np.ndarray], threshold: float = 0.1) -> list[np.ndarray]:
    """Sort by normalized SNR proxy, filter below threshold, keep >= 1
    (reference activity.py:160-185)."""
    values = np.array([get_s2n(s) for s in samples])
    # Parity with the reference (activity.py:178): divide by max even when
    # it is negative (all-negative proxies then invert the ranking) — the
    # two frameworks must select the same chunks from the same audio.
    values = values / (values.max() + 1e-10)
    order = np.argsort(values)[::-1]
    kept = [samples[i] for i in order if values[i] >= threshold]
    return kept if kept else [samples[order[0]]]


def get_activity_ratio(x: np.ndarray, k: float = 2.0, max_active: float = 0.8,
                       subsample: int = 512) -> float:
    """Fraction of units above median + k*MAD, zeroed when broadband
    (reference activity.py:188-214)."""
    x = np.abs(x)
    flat = x.ravel()
    if flat.size > subsample:
        flat = flat[np.linspace(0, flat.size - 1, subsample, dtype=int)]
    med = np.median(flat)
    mad = np.median(np.abs(flat - med)) + 1e-10
    ratio = float(np.count_nonzero(x > med + k * mad)) / float(x.size)
    return 0.0 if ratio > max_active else ratio


def sort_by_activity(samples: list[np.ndarray], threshold: float = 0.25,
                     return_indices: bool = False):
    """Sort by activity ratio, filter, keep >= 1 (reference activity.py:217-233).

    return_indices=True returns indices into `samples` instead of the
    samples themselves (same order/filter), so a parallel array can be
    selected identically (int16 shipping path)."""
    activity = np.array([get_activity_ratio(s) for s in samples])
    order = np.argsort(activity)[::-1]
    kept = [i for i in order if activity[i] >= threshold]
    if not kept:
        kept = [order[0]]
    if return_indices:
        return [int(i) for i in kept]
    return [samples[i] for i in kept]


def pick_random_samples(samples: list, num_samples: int = 1, pick_first: bool = False,
                        rng: np.random.Generator | None = None):
    """Random selection with optional always-include-first
    (reference activity.py:236-271)."""
    rng = rng or np.random.default_rng()
    if len(samples) == 0:
        return []
    num_samples = min(num_samples, len(samples))
    if pick_first:
        if num_samples == 1:
            return samples[0]
        rest = min(num_samples - 1, len(samples) - 1)
        if rest > 0:
            idx = rng.choice(len(samples) - 1, size=rest, replace=False) + 1
            return [samples[0]] + [samples[i] for i in idx]
        return [samples[0]]
    idx = rng.choice(len(samples), size=num_samples, replace=False)
    return [samples[i] for i in idx] if num_samples > 1 else samples[idx[0]]
