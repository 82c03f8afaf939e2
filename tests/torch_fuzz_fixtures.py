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


# --- score gates that bite ------------------------------------------------
# The fuzz configurations are random-init models: their softmax / sigmoid
# scores are near-uniform (float32 ptp 6e-8 to 9e-3 per row), so a gate on
# scores passes a constant vector and the class-shuffled scores alike. The
# gates below compare logits (class_activation 'none') and executor tensors,
# and every one of them fails on both of those (see bad_outputs).

# float32 logits, one side against the other: max |got - ref| per row
# within this share of the row's spread (max - min). The port's CPU logits
# read at most 3.9e-6 of the spread from JAX's on the nine configurations;
# a constant row reads >= 0.50 and a class-shuffled one >= 0.57.
LOGIT_SPREAD_RTOL = 1e-4
# bf16 logits against JAX's bf16 (or the port's float32) logits: per-row
# cosine. JAX's own bf16 logits read 0.9965 against its float32 logits
# (config 7), the port's bf16 0.9981 against JAX's bf16; a constant row
# reads at most 0.94 and a class-shuffled one 0.94.
BF16_LOGIT_MIN_COSINE = 0.99


def bad_outputs(ref: np.ndarray) -> dict[str, np.ndarray]:
    """A constant output (each row's mean) and the class-shuffled one (each
    row rolled by one class), the two outputs every score gate must fail."""
    ref = np.asarray(ref)
    return {"constant": np.repeat(ref.mean(axis=-1, keepdims=True), ref.shape[-1], axis=-1),
            "shuffled": np.roll(ref, 1, axis=-1)}


def spread_error(got: np.ndarray, ref: np.ndarray) -> float:
    """max over rows of max |got - ref| / (max - min of the ref row)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref).max(axis=-1) / np.ptp(ref, axis=-1)).max())


def row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def logits_match(got: np.ndarray, ref: np.ndarray) -> bool:
    """The float32 logit gate."""
    return spread_error(got, ref) <= LOGIT_SPREAD_RTOL


def bf16_logits_match(got: np.ndarray, ref: np.ndarray) -> bool:
    """The bf16 logit gate."""
    return bool(row_cosines(got, ref).min() >= BF16_LOGIT_MIN_COSINE)


def logits_tensor(graph) -> int:
    """The index of the graph's int8 logits: the last FULLY_CONNECTED output."""
    return [op for op in graph.ops if op.name == "FULLY_CONNECTED"][-1].outputs[0]


def executor_tensors_match(got: dict, ref: dict, graph) -> list[str]:
    """Every tensor an executor computed (build_executor(return_all=True))
    against another executor's: bit-equal, except from the first SOFTMAX
    on, where the device's exp and sum may move a code by one (within one
    quantum, MIN_EXACT_SHARE exact). Returns the failures (empty: a match)."""
    first_softmax = next((k for k, op in enumerate(graph.ops) if op.name == "SOFTMAX"),
                         len(graph.ops))
    after = {t for op in graph.ops[first_softmax:] for t in op.outputs}
    failures = []
    for idx in sorted(set(ref) - {t.index for t in graph.tensors if t.data is not None}):
        a, b = (np.asarray(v.cpu() if hasattr(v, "cpu") else v) for v in (got[idx], ref[idx]))
        if a.shape != b.shape:
            failures.append(f"tensor {idx}: shape {a.shape} vs {b.shape}")
        elif idx in after:
            step = 1 if a.dtype == np.int8 else ONE_QUANTUM  # one code
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            if d.max(initial=0) > step * (1 + 1e-6) or (d == 0).mean() < MIN_EXACT_SHARE:
                failures.append(f"tensor {idx} (after SOFTMAX): max {d.max()}")
        elif not np.array_equal(a, b):
            failures.append(f"tensor {idx}: {int((a != b).sum())} of {a.size} differ")
    return failures
