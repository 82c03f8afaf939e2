"""Multiply-accumulates of one chunk through the stand-in model
(reference.py beside this file): the hybrid mel mixer, the stem and the
inverted-residual blocks with SE, the head. Each BN is folded into the
convolution before it, so it counts no MAC of its own (the DS-CNN's count,
gpubench/yardstick/macs_dscnn.py, gives BN one MAC per element). The stand-in
test copies it into a copy of gpubench/ as yardstick/macs_dscnn_ir_se.py."""

from __future__ import annotations

import math


def _divisible(v: float, d: int = 8) -> int:
    return max(d, int(v + d / 2) // d * d)


def model_macs(config: dict) -> int:
    h, w = config["num_mels"], -(-config["spec_width"] // 2)
    total = (config["fft_length"] // 2 + 1) * config["num_mels"] * config["spec_width"]
    cin = _divisible(16 * config["alpha"])
    total += 9 * cin * h * w
    for bf, br in zip((32, 64, 128, 256), (2, 3, 4, 2)):
        cout = _divisible(int(bf * config["alpha"]))
        for bi in range(1, max(1, int(math.ceil(br * config["depth_multiplier"]))) + 1):
            hidden = _divisible(cin * config["expansion_factor"])
            total += h * w * cin * hidden
            if bi == 1:
                h, w = -(-h // 2), -(-w // 2)
            total += h * w * (9 * hidden + hidden * cout)
            if config["use_se"]:
                total += 2 * hidden * max(1, hidden // config["se_reduction"])
            cin = cout
    emb = _divisible(config["embeddings_size"])
    if cin != emb:
        total += h * w * cin * emb
        cin = emb
    return total + cin * config["num_classes"]
