"""Per-file waveform chunks for serving (port of evaluation/metrics.py::
chunks_for_file; the metrics themselves are not ported yet, ROADMAP.md)."""

from __future__ import annotations

import numpy as np

from birdnet_stm32_tpu_torch.audio.io import load_audio_file


def chunks_for_file(path: str, cfg, overlap: float = 0.0, max_duration: float | None = 60.0,
                    sample_rate: int | None = None) -> np.ndarray:
    """[n_chunks, T] waveform chunks for one file.

    `sample_rate` overrides cfg.sample_rate for device-resample serving:
    chunks come back at the file's native rate (T = chunk_duration * rate)
    and the classifier resamples on the device (ops/resample.py).
    """
    return load_audio_file(path, sample_rate=sample_rate or cfg.sample_rate,
                           max_duration=max_duration, chunk_duration=cfg.chunk_duration,
                           chunk_overlap=overlap, random_offset=False)
