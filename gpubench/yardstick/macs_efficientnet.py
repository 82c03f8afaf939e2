"""Multiply-accumulates of one chunk through EfficientNet-B1 and its hybrid
mel mixer, and the counts the MBConv readers need, from the
configuration's geometry and the stage table of the plain reference
(gpubench/reference/efficientnet.py::blocks).

As the paper counts (Tan & Le 2019: 0.70 B for B1 at 240 x 240 x 3), MACs
are those of the convolutions and dense layers; BN, activations, the SE
product and the residual adds are not counted. Spatial sizes follow TF's
"SAME" padding: a stride-2 convolution over n gives ceil(n / 2).
"""

from __future__ import annotations

from gpubench.reference.efficientnet import STEM, TOP, blocks

ITEM_BYTES = {"bfloat16": 2, "float32": 4}  # gpubench/system.py's precisions


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _layers(h: int, w: int, channels: int = 1):
    """(kind, MACs, depthwise elements read, written and held as weights)
    of each layer of the backbone on an h x w input, per chunk."""
    h, w = _ceil_div(h, 2), _ceil_div(w, 2)
    yield "stem", 9 * channels * STEM * h * w, 0, 0, 0
    for _, cin, cout, k, s, e, se in blocks():
        hidden = cin * e
        if e != 1:
            yield "expand", h * w * cin * hidden, 0, 0, 0
        h_in, w_in = h, w
        h, w = _ceil_div(h, s), _ceil_div(w, s)
        yield "dw", k * k * hidden * h * w, hidden * h_in * w_in, hidden * h * w, hidden * k * k
        yield "se", 2 * hidden * se, 0, 0, 0
        yield "project", h * w * hidden * cout, 0, 0, 0
    yield "top", h * w * blocks()[-1][2] * TOP, 0, 0, 0


def backbone_macs(h: int, w: int, channels: int = 1, classes: int = 0) -> int:
    """MACs of the stem, the 23 blocks, the 1 x 1 top and a dense head over
    `classes`, for an h x w input of `channels`."""
    return sum(m for _, m, *_ in _layers(h, w, channels)) + TOP * classes


def model_macs(config: dict) -> int:
    """MACs per chunk for a configuration's geometry: the hybrid mel mixer
    over the spectrogram, then the backbone and the head."""
    M, W = config["num_mels"], config["spec_width"]
    mixer = (config["fft_length"] // 2 + 1) * M * W
    return mixer + backbone_macs(M, W, 1, config["num_classes"])


def pointwise_flops(config: dict, rows: int) -> float:
    """Operations (2 per MAC) of every block's 1 x 1 expand and project
    convolutions over `rows` chunks."""
    return 2.0 * rows * sum(m for kind, m, *_ in _layers(config["num_mels"], config["spec_width"])
                            if kind in ("expand", "project"))


def depthwise_bytes(config: dict, rows: int) -> float:
    """Bytes every block's depthwise convolution must move over `rows`
    chunks at the configuration's precision: its input read once, its
    output written once, per chunk, and its weights read once."""
    size = ITEM_BYTES[config["precision"]]
    n = 0
    for kind, _, read, written, weights in _layers(config["num_mels"], config["spec_width"]):
        if kind == "dw":
            n += rows * (read + written) + weights
    return float(n * size)
