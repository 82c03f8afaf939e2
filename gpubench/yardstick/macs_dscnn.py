"""Multiply-accumulates of one chunk through the DS-CNN and its hybrid mel
mixer, from the configuration's geometry (a frozen copy of the arithmetic
of the port's models/profiler.py::profile_model; BN counts one MAC per
element there and here)."""

from __future__ import annotations

import math

BASE_FILTERS = (32, 64, 128, 256)
BASE_REPEATS = (2, 3, 4, 2)


def _divisible(v: float, d: int = 8) -> int:
    return max(d, int(v + d / 2) // d * d)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def model_macs(m: dict) -> int:
    """MACs per chunk for a configuration's `model` keys."""
    M, W = m["num_mels"], m["spec_width"]
    total = 0
    if m["audio_frontend"] == "hybrid":
        total += (m["fft_length"] // 2 + 1) * M * W  # mel mixer
        total += 4 * M * W  # magnitude scaling
    elif m["audio_frontend"] == "raw":
        total += 16 * M * W + M * W + 4 * M * W
    h, w = (m["n_mfcc"] if m["audio_frontend"] == "mfcc" else M), W
    stem = _divisible(16 * m["alpha"])
    w = _ceil_div(w, 2)
    total += 9 * stem * h * w + h * w * stem  # stem conv + BN
    cin = stem
    for bf, br in zip(BASE_FILTERS, BASE_REPEATS):
        cout = _divisible(int(bf * m["alpha"]))
        for bi in range(1, max(1, int(math.ceil(br * m["depth_multiplier"]))) + 1):
            s = 2 if bi == 1 else 1
            h_in, w_in = h, w
            h, w = _ceil_div(h, s), _ceil_div(w, s)
            if m["use_inverted_residual"]:
                hidden = _divisible(cin * m["expansion_factor"])
                total += h_in * w_in * cin * hidden + h_in * w_in * hidden
                total += 9 * hidden * h * w + h * w * hidden
                if m["use_se"]:
                    total += 2 * hidden * max(1, hidden // m["se_reduction"])
                total += h * w * hidden * cout + h * w * cout
            else:
                total += 9 * cin * h * w + h * w * cin
                total += h * w * cin * cout + h * w * cout
                if m["use_se"]:
                    total += 2 * cout * max(1, cout // m["se_reduction"])
            cin = cout
    emb = _divisible(m["embeddings_size"])
    if cin != emb:
        total += h * w * cin * emb + h * w * emb
        cin = emb
    if m["use_attention_pooling"]:
        total += h * w * cin
    total += cin * m["num_classes"]
    return total
