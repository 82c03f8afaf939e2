"""Sustained-throughput measurement (port of utils/benchmarking.py).

`fn(wave)` returns a scalar tensor that depends on every output element.
PyTorch enqueues CUDA work and returns before the card has run it, so the
clock runs over `iters` calls enqueued back to back and one scalar read at
the end (`float(out)`, which waits for the stream: the card ran every
queued call in order). That is how a serving loop streams batches: the
host rarely blocks. `sustained_carried_chunks_per_sec`, the training
variant, comes with the training slice.
"""

from __future__ import annotations

import time


def sustained_chunks_per_sec(fn, wave, iters: int = 20, reps: int = 3) -> float:
    """Best-of-`reps` chunks per second of `fn(wave) -> scalar` over a
    [B, ...] batch `wave`. The first call (kernel build, allocator warm-up)
    and its drain stay outside the clock."""
    float(fn(wave))
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(wave)
        float(out)
        best = max(best, iters * wave.shape[0] / (time.perf_counter() - t0))
    return best
