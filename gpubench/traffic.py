"""The one traffic generator: a traffic mix's parameters (a JSON file under
gpubench/traffic/) and a seed -> the request inputs and their order.

Parameters of a mix:
- loop: "closed" (one client: it sends its next request when the last
  one's scores are on the host). Other loop kinds are added beside it.
- rows: chunks per request.
- input_dtype: "int16" ([rows, T + 1] PCM16 codes with the chunk's peak in
  a scale column) or "float32" ([rows, T]).
- input_rate: the rate the chunks arrive at (null: the model's rate).
- cards: how many local cards one request is served over.
- pool: distinct request batches made at set-up and cycled through, in an
  order drawn from the seed.
- signal: the audio of a chunk: `tones` swept sinusoids with start
  frequency, sweep rate and amplitude drawn uniformly from the ranges
  given, plus white noise of a level drawn from `noise`.
- warmup_rounds: set-up passes over the pool.
- trace_calls: requests profiled at the start of a traced run's window.

Every seed gets the same sizes, rates and number of requests per pool;
only the audio and the order differ.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
LOOPS = ("closed",)


def load(name: str) -> dict:
    mix = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    if mix["loop"] not in LOOPS:
        raise ValueError(f"traffic {name}: unknown loop {mix['loop']!r}")
    return mix


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


def chunk_audio(mix: dict, rows: int, samples: int, rate: int, g) -> np.ndarray:
    """[rows, samples] float32 waveforms in [-1, 1], drawn with the torch
    Generator `g` on its device (the card in a benchmark run) in float64."""
    import torch

    sig, dev = mix["signal"], g.device

    def uniform(lo_hi, shape):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev, dtype=torch.float64)

    t = torch.arange(samples, device=dev, dtype=torch.float64) / rate
    wave = torch.zeros((rows, samples), device=dev, dtype=torch.float64)
    for _ in range(sig["tones"]):
        f0 = uniform(sig["freq_hz"], (rows, 1))
        sweep = uniform(sig["sweep_hz_per_s"], (rows, 1))
        amp = uniform(sig["amplitude"], (rows, 1))
        phase = uniform((0.0, 2.0 * np.pi), (rows, 1))
        wave += amp * torch.sin(phase + 2.0 * np.pi * (f0 * t + 0.5 * sweep * t * t))
    wave += uniform(sig["noise"], (rows, 1)) * torch.randn(
        (rows, samples), generator=g, device=dev, dtype=torch.float64)
    wave = torch.clamp(wave / max(1.0, sig["tones"] * sig["amplitude"][1]), -1.0, 1.0)
    return wave.float().cpu().numpy()


def encode(wave: np.ndarray, input_dtype: str) -> np.ndarray:
    """Float chunks -> what the program is handed."""
    if input_dtype == "float32":
        return wave
    if input_dtype == "int16":
        codes = np.clip(np.round(wave * 32767.0), -32768, 32767).astype(np.int16)
        peak = np.maximum(np.abs(codes.astype(np.int32)).max(axis=1, keepdims=True), 1)
        return np.concatenate([codes, peak.astype(np.int16)], axis=1)
    raise ValueError(f"unknown input_dtype {input_dtype!r}")


def make_pool(mix: dict, model: dict, seed: int, device="cpu") -> list[np.ndarray]:
    """The mix's distinct request batches for this seed, drawn on `device`
    and handed over as host arrays."""
    import torch

    rate = mix.get("input_rate") or model["sample_rate"]
    samples = int(round(rate * model["chunk_duration"]))
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2**63 - 1))
    return [encode(chunk_audio(mix, mix["rows"], samples, rate, g), mix["input_dtype"])
            for _ in range(mix["pool"])]


def request_order(mix: dict, seed: int):
    """The pool index of each request, in order: the pool shuffled afresh
    for each pass."""
    rng = _rng(seed, 2)
    while True:
        yield from (int(i) for i in rng.permutation(mix["pool"]))
