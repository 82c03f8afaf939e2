"""The committed executor-fuzz fixtures, read without JAX.

tests/make_torch_fuzz_fixtures.py (which needs JAX and TensorFlow) writes,
for each of the JAX package's nine fuzz configurations
(tests/test_executor_fuzz.py), tests/goldens/torch_fuzz/<i>.tflite and
<i>.npz. This module loads them for the port's CPU tests and for
chip_smoke.py on the card, where there is neither JAX nor TensorFlow.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

FUZZ_DIR = Path(__file__).resolve().parent / "goldens" / "torch_fuzz"
N_CONFIGS = 9
# The per-graph gate of tests/test_executor_fuzz.py for float-faithful ops
# (SOFTMAX's exp and sum): within one output quantum of an int8 softmax or
# sigmoid (scale 1/256), and mostly exact.
ONE_QUANTUM = 1.5 / 256.0
MIN_EXACT_SHARE = 0.95


@dataclass
class FuzzFixture:
    index: int
    cfg: dict  # ModelConfig.to_dict() of the configuration
    class_activation: str
    per_channel: bool
    tflite: bytes
    features: np.ndarray  # the fuzz test's graph inputs [6, ...]
    int8_exact: np.ndarray  # the jitted JAX executor's outputs on them
    int8_fast: np.ndarray  # the same with requant='fast'
    variables: dict  # {'params': ..., 'batch_stats': ...} nested numpy
    float_f32: np.ndarray  # the Flax model's scores on the features
    float_bf16: np.ndarray  # the same through FlaxRunner(dtype=bfloat16)
    waves: np.ndarray  # seeded waveforms [3, chunk_samples]
    wave_features: np.ndarray  # JAX inputs_for_config(waves) (float32, 'highest')

    @property
    def label(self) -> str:
        c = self.cfg
        return (f"{self.index}:{c['audio_frontend']}+{c['mag_scale']}"
                f"/{self.class_activation}" + ("" if self.per_channel else "/per-tensor"))


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")[1:]  # drop the 'var' prefix
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@functools.lru_cache(maxsize=None)
def load(i: int) -> FuzzFixture:
    with np.load(FUZZ_DIR / f"{i}.npz") as d:
        arrays = {k: d[k] for k in d.files}
    return FuzzFixture(
        index=i, cfg=json.loads(str(arrays["cfg_json"])),
        class_activation=str(arrays["class_activation"]),
        per_channel=bool(arrays["per_channel"]),
        tflite=(FUZZ_DIR / f"{i}.tflite").read_bytes(),
        features=arrays["features"], int8_exact=arrays["int8_exact"],
        int8_fast=arrays["int8_fast"],
        variables=_nest({k: v for k, v in arrays.items() if k.startswith("var/")}),
        float_f32=arrays["float_f32"], float_bf16=arrays["float_bf16"],
        waves=arrays["waves"], wave_features=arrays["wave_features"])


def all_fixtures() -> list[FuzzFixture]:
    return [load(i) for i in range(N_CONFIGS)]


def has_float_faithful_ops(graph) -> bool:
    """Whether a graph holds an op whose codes the device's float math can
    move by one against XLA's (SOFTMAX's exp and sum)."""
    return any(op.name == "SOFTMAX" for op in graph.ops)


def within_one_quantum(got: np.ndarray, ref: np.ndarray) -> tuple[float, float]:
    """(max |diff|, share exactly equal) of two dequantized outputs."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return float(diff.max()), float((diff == 0).mean())
