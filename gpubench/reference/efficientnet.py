"""EfficientNet-B1 with the hybrid frontend, written out in plain torch
float32 (Tan & Le, "EfficientNet: Rethinking Model Scaling for
Convolutional Neural Networks", ICML 2019, arXiv:1905.11946; layer for
layer as Keras's EfficientNetB1 builds it, eval mode).

hybrid input [B, F, W, 1] -> mel mixer (F x M matmul) -> ReLU -> divide by
the sample's max + 1e-6 -> pwl curve per mel channel -> [B, 1, M, W] ->
stem 3x3 conv, stride 2, 32 channels -> BN -> SiLU -> 23 MBConv blocks
(`blocks`: B0's stage table with B1's depth 1.1 and width 1.0): 1x1
expand to the input width x expansion -> BN -> SiLU (expansion 6; none at
1) -> k x k depthwise, the stage's stride on its first block -> BN -> SiLU
-> squeeze-and-excite (global mean -> dense with bias to max(1, int(input
width / 4)) -> SiLU -> dense with bias back -> sigmoid -> product) -> 1x1
project -> BN (+ the block's input when the stride is 1 and the widths
match) -> 1x1 conv to 1280 -> BN -> SiLU -> global average -> dense ->
scores. Convolutions pad as TensorFlow's "SAME", which is Keras's
correct_pad before its stride-2 convolutions; BN in eval mode with eps
1e-3.

Departures from the paper: a 1-channel spectrogram in place of RGB (the
stem takes one channel) with no rescaling layer; the hybrid frontend in
front of the stem; no drop-connect and no dropout (eval mode).

`cast` is applied to the operands of every convolution and matmul: the
identity for the reference, a lower precision for the control. Rows are
worked in blocks of ROW_BLOCK.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.dscnn import _bn, _conv, _identity

PWL_STEPS = 3
ROW_BLOCK = 16
# B0's stages (the paper's Table 1): kernel, repeats, input width, output
# width, expansion, stride.
B0_STAGES = ((3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2),
             (3, 3, 40, 80, 6, 2), (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
             (3, 1, 192, 320, 6, 1))
DEPTH = 1.1  # B1's depth coefficient; at its width 1.0 B0's widths stand
STEM, TOP = 32, 1280
SE_RATIO = 0.25


def blocks() -> list[tuple[str, int, int, int, int, int, int]]:
    """(name, input width, output width, kernel, stride, expansion, SE
    width) of each MBConv block, in order."""
    out = []
    for si, (k, reps, cin, cout, e, s) in enumerate(B0_STAGES, start=1):
        for bi in range(math.ceil(DEPTH * reps)):
            c = cin if bi == 0 else cout
            out.append((f"block{si}{chr(97 + bi)}", c, cout, k, s if bi == 0 else 1, e,
                        max(1, int(c * SE_RATIO))))
    return out


def _dense(x, sd, name, cast):
    return cast(x) @ cast(sd[f"{name}.weight"]).T + sd[f"{name}.bias"]


def backbone(sd: dict, x: torch.Tensor, cast=_identity) -> torch.Tensor:
    """[B, 1, H, W] float32 spectrogram -> [B, classes] float32 logits."""
    x = F.silu(_bn(_conv(x, sd["stem_conv.weight"], (2, 2), 1, cast), sd, "stem_bn"))
    for name, cin, cout, k, s, e, _ in blocks():
        y = x
        if e != 1:
            y = F.silu(_bn(_conv(y, sd[f"{name}_expand_conv.weight"], (1, 1), 1, cast), sd,
                           f"{name}_expand_bn"))
        y = _conv(y, sd[f"{name}_dwconv.weight"], (s, s), y.shape[1], cast)
        y = F.silu(_bn(y, sd, f"{name}_bn"))
        se = F.silu(_dense(y.mean(dim=(2, 3)), sd, f"{name}_se_reduce", cast))
        y = y * torch.sigmoid(_dense(se, sd, f"{name}_se_expand", cast))[:, :, None, None]
        y = _bn(_conv(y, sd[f"{name}_project_conv.weight"], (1, 1), 1, cast), sd,
                f"{name}_project_bn")
        x = x + y if s == 1 and cin == cout else y
    x = F.silu(_bn(_conv(x, sd["top_conv.weight"], (1, 1), 1, cast), sd, "top_bn"))
    return _dense(x.mean(dim=(2, 3)), sd, "predictions", cast)


def spectrogram(sd: dict, feats: torch.Tensor, model: dict, cast=_identity) -> torch.Tensor:
    """[B, F, W, 1] hybrid input -> [B, 1, M, W]: the mel mixer, ReLU, the
    per-sample max normalisation and the pwl curve."""
    y = feats[:, :, :model["spec_width"], 0].transpose(1, 2)  # [B, W, F]
    y = torch.relu(cast(y) @ cast(sd["audio_frontend.mel_mixer"]))
    y = y / (y.amax(dim=(1, 2), keepdim=True) + 1e-6)
    p = "audio_frontend.mag."
    out = sd[p + "pwl_k0"] * y
    for i in range(1, PWL_STEPS + 1):
        out = out + sd[f"{p}pwl_k{i}"] * torch.relu(sd[f"{p}pwl_shift{i}_w"] * y
                                                     + sd[f"{p}pwl_shift{i}_b"])
    return out.transpose(1, 2)[:, None]


@torch.no_grad()
def scores(sd: dict, feats: torch.Tensor, model: dict, cast=_identity) -> torch.Tensor:
    if model["audio_frontend"] != "hybrid" or model["mag_scale"] != "pwl":
        raise ValueError("the reference writes out the hybrid frontend with pwl only")
    z = torch.cat([backbone(sd, spectrogram(sd, feats[i:i + ROW_BLOCK], model, cast), cast)
                   for i in range(0, feats.shape[0], ROW_BLOCK)])
    return torch.sigmoid(z) if model["class_activation"] == "sigmoid" else torch.softmax(z, -1)
