"""The comparison that decides `correct`.

Every answer of the window is compared: each request's scores against the
plain reference's scores of the same input batch (gpubench/reference/),
worked out once per distinct batch of the pool after the window, on the
CPU, from the raw inputs and weights the harness made. The configuration's
`model` names the reference (gpubench/reference/<model>.py: its `scores`
for a float runner, its `features` or frontend.py's for every runner); an
INT8 graph runs through int8.py. The number compared is `score_gap`, the
widest gap between a served score and the reference's score of the same
chunk and class, over every answer; a configuration's file gives its
limit. An answer that is missing, of the wrong shape or not
finite fails the run, and so does a request that raised.

The control puts the reference in the program's place at the precision
below the configuration's (`control_scores`): int4 weights for an int8
graph, fp8 (e4m3, per-tensor scale) operands for bfloat16.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gpubench import reference
from gpubench.reference import frontend, int8

FP8_MAX = 448.0
INT4_STEP = 16  # int8 codes -> int4 codes * 16 (the int4 grid, scale x 16)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _int8_graph(config: dict, root: Path, int4: bool = False):
    graph = int8.load(root / config["tflite"])
    if int4:
        for op in graph.ops:
            if op.kind in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
                t = graph.tensors[op.inputs[1]]
                if t.data is not None and t.dtype == np.int8:
                    q4 = np.clip(np.round(t.data.astype(np.float64) / INT4_STEP), -8, 7)
                    t.data = (q4 * INT4_STEP).astype(np.int8)
    return graph


def reference_scores(config: dict, mix: dict, pool: list, weights: dict | None,
                     root: Path, control: bool = False) -> list[np.ndarray]:
    """[rows, classes] float32 scores of each pool batch by the plain
    reference (`control`: at the precision below the configuration's)."""
    ref = reference.model(config["model"])
    features = getattr(ref, "features", frontend.features)
    feats = [features(b, config, mix) for b in pool]
    if config["runner"] == "tflite_sim":
        graph = _int8_graph(config, root, int4=control)
        return [int8.run(graph, f) for f in feats]
    if config["runner"] == "torch":
        cast = _fp8 if control else (lambda x: x)
        return [ref.scores(weights, torch.from_numpy(f), config, cast).numpy()
                for f in feats]
    raise ValueError(f"no reference for runner {config['runner']!r}")


def compare(answers: list, order, refs: list[np.ndarray]) -> dict:
    """{name: value} of the numbers compared. `answers[i]` are request i's
    scores (None when it never came or its call raised), `order[i]` its
    pool batch."""
    gap, missing, bad = 0.0, 0, 0
    for i, got in enumerate(answers):
        if got is None:
            missing += 1
            continue
        want = refs[int(order[i])]
        if got.shape != want.shape or not np.isfinite(got).all():
            bad += 1
            continue
        gap = max(gap, float(np.abs(got.astype(np.float64) - want).max()))
    return {"score_gap": gap, "unanswered": missing, "malformed": bad}


def verdict(numbers: dict, limit: float | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers of compare()."""
    checks = {
        "score_gap": {"value": numbers["score_gap"], "limit": limit},
        "unanswered": {"value": numbers["unanswered"], "limit": 0},
        "malformed": {"value": numbers["malformed"], "limit": 0},
    }
    ok = limit is not None and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
