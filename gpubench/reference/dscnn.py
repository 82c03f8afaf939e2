"""The DS-CNN with the hybrid frontend, written out in plain torch float32
(birdnet-stm32's models/dscnn.py, plain DS blocks, eval mode).

hybrid input [B, F, W, 1] -> mel mixer (F x M matmul) -> ReLU -> divide by
the sample's max + 1e-6 -> pwl curve per mel channel -> [B, 1, M, W] ->
stem 3x3 conv, stride (1, 2) -> BN -> ReLU6 -> 4 stages of DS blocks
(filters 32, 64, 128, 256 x alpha, repeats 2, 3, 4, 2 x depth multiplier,
stride 2 on each stage's first block): depthwise 3x3 -> BN -> ReLU6 -> 1x1
-> BN -> (+ input when the stride is 1 and the channels match) -> ReLU6 ->
a 1x1 conv + BN to the embedding width when it differs -> global average
-> dense -> logits. Convolutions pad as TensorFlow's "SAME". BN in eval
mode with eps 1e-3.

`cast` is applied to the operands of every convolution and matmul: the
identity for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
PWL_STEPS = 3


def _divisible(v: float, d: int = 8) -> int:
    return max(d, int(v + d / 2) // d * d)


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _conv(x, w, stride, groups, cast):
    kh, kw = w.shape[2:]
    hl, hh = _same(x.shape[2], kh, stride[0])
    wl, wh = _same(x.shape[3], kw, stride[1])
    x = F.pad(x, (wl, wh, hl, hh))
    return F.conv2d(cast(x), cast(w), stride=stride, groups=groups)


def _bn(x, sd, name):
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(sd[f"{name}.running_var"] + BN_EPS) * sd[f"{name}.weight"]
    return (x - sd[f"{name}.running_mean"].view(shape)) * inv.view(shape) \
        + sd[f"{name}.bias"].view(shape)


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def blocks(model: dict) -> list[tuple[str, int, int, int]]:
    """(name, in channels, out channels, stride) of each DS block."""
    out, cin = [], _divisible(16 * model["alpha"])
    for si, (bf, br) in enumerate(zip((32, 64, 128, 256), (2, 3, 4, 2)), start=1):
        cout = _divisible(int(bf * model["alpha"]))
        for bi in range(1, max(1, int(math.ceil(br * model["depth_multiplier"]))) + 1):
            out.append((f"stage{si}_ds{bi}", cin, cout, 2 if bi == 1 else 1))
            cin = cout
    return out


@torch.no_grad()
def logits(sd: dict, feats: torch.Tensor, model: dict, cast=_identity) -> torch.Tensor:
    """[B, F, W, 1] float32 features -> [B, classes] float32 logits; `sd`
    maps the layer names to float32 CPU tensors."""
    if model["use_se"] or model["use_inverted_residual"] or model["use_attention_pooling"]:
        raise ValueError("the reference writes out the plain DS-CNN only")
    W = model["spec_width"]
    y = feats[:, :, :W, 0].transpose(1, 2)  # [B, W, F]
    y = torch.relu(cast(y) @ cast(sd["audio_frontend.mel_mixer"]))
    y = y / (y.amax(dim=(1, 2), keepdim=True) + 1e-6)
    p = "audio_frontend.mag."
    out = sd[p + "pwl_k0"] * y
    for i in range(1, PWL_STEPS + 1):
        out = out + sd[f"{p}pwl_k{i}"] * torch.relu(sd[f"{p}pwl_shift{i}_w"] * y
                                                     + sd[f"{p}pwl_shift{i}_b"])
    x = out.transpose(1, 2)[:, None]  # [B, 1, M, W]
    x = _relu6(_bn(_conv(x, sd["stem_conv.weight"], (1, 2), 1, cast), sd, "stem_bn"))
    for name, cin, cout, s in blocks(model):
        y = _conv(x, sd[f"{name}_dw.weight"], (s, s), cin, cast)
        y = _relu6(_bn(y, sd, f"{name}_dw_bn"))
        y = _bn(_conv(y, sd[f"{name}_pw.weight"], (1, 1), 1, cast), sd, f"{name}_pw_bn")
        if s == 1 and cin == cout:
            y = x + y
        x = _relu6(y)
    if "emb_conv.weight" in sd:
        x = _relu6(_bn(_conv(x, sd["emb_conv.weight"], (1, 1), 1, cast), sd, "emb_bn"))
    emb = x.mean(dim=(2, 3))
    return cast(emb) @ cast(sd["pred.weight"]).T + sd["pred.bias"]


def scores(sd: dict, feats: torch.Tensor, model: dict, cast=_identity) -> torch.Tensor:
    z = logits(sd, feats, model, cast)
    return torch.sigmoid(z) if model["class_activation"] == "sigmoid" else torch.softmax(z, -1)
