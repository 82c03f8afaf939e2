"""A stand-in second model for the benchmark's tests, written out in plain
torch float32 (eval mode): the DS-CNN with inverted-residual blocks and
squeeze-and-excite behind the hybrid frontend with pcen, which
gpubench/reference/dscnn.py refuses. The stand-in test copies it into a
copy of gpubench/ as reference/dscnn_ir_se.py.

hybrid input [B, F, W, 1] -> mel mixer -> ReLU -> divide by the sample's
max + 1e-6 -> pcen per mel channel (y0 = relu(y - agc y); relu(k1 y0 +
k2mk1 relu(shift_w y0 + shift_b))) -> [B, 1, M, W] -> stem 3x3 conv,
stride (1, 2) -> BN -> ReLU6 -> 4 stages of inverted-residual blocks
(filters 32, 64, 128, 256 x alpha, repeats 2, 3, 4, 2 x depth multiplier,
stride 2 on each stage's first block): 1x1 expand to the input width x
expansion_factor -> BN -> ReLU6 -> depthwise 3x3 -> BN -> ReLU6 -> SE
(global mean -> dense to width / se_reduction -> ReLU -> dense back ->
sigmoid, no biases) -> 1x1 project -> BN (+ input when the stride is 1 and
the channels match) -> a 1x1 conv + BN + ReLU6 to the embedding width when
it differs -> global average -> dense -> scores. Convolutions pad as
TensorFlow's "SAME"; BN eps 1e-3.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
# pcen's published defaults; the stand-in seeds each within 10 % of its own.
PCEN = {"pcen_agc": 0.6, "pcen_k1": 0.15, "pcen_shift_w": 1.0, "pcen_shift_b": -0.2,
        "pcen_k2mk1": 0.45}


def seeded(name, shape, z, u, config):
    """pcen's parameters, for which gpubench/weights.py has no rule: each
    default times U(0.9, 1.1)."""
    default = PCEN.get(name.rsplit(".", 1)[-1])
    return None if default is None else default * (0.9 + 0.2 * u)


def _divisible(v: float, d: int = 8) -> int:
    return max(d, int(v + d / 2) // d * d)


def _conv(x, w, stride, cast, groups=1):
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(w.shape[2:]), reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(cast(F.pad(x, pads)), cast(w), stride=stride, groups=groups)


def _bn(x, sd, name):
    shape = (1, -1, 1, 1)
    scale = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + BN_EPS)
    return (x - sd[f"{name}.running_mean"].view(shape)) * scale.view(shape) \
        + sd[f"{name}.bias"].view(shape)


def _relu6(x):
    return x.clamp(0.0, 6.0)


def _dense(x, w, cast):
    return cast(x) @ cast(w).T


@torch.no_grad()
def scores(sd: dict, feats: torch.Tensor, config: dict, cast) -> torch.Tensor:
    """[B, F, W, 1] float32 features -> [B, classes] float32 scores."""
    y = feats[:, :, :config["spec_width"], 0].transpose(1, 2)  # [B, W, F]
    y = torch.relu(cast(y) @ cast(sd["audio_frontend.mel_mixer"]))
    y = y / (y.amax(dim=(1, 2), keepdim=True) + 1e-6)
    p = {k: sd[f"audio_frontend.mag.{k}"] for k in PCEN}
    y0 = torch.relu(y - p["pcen_agc"] * y)
    y = torch.relu(p["pcen_k1"] * y0
                   + p["pcen_k2mk1"] * torch.relu(p["pcen_shift_w"] * y0 + p["pcen_shift_b"]))
    x = y.transpose(1, 2)[:, None]  # [B, 1, M, W]
    x = _relu6(_bn(_conv(x, sd["stem_conv.weight"], (1, 2), cast), sd, "stem_bn"))
    cin = x.shape[1]
    for si, (bf, br) in enumerate(zip((32, 64, 128, 256), (2, 3, 4, 2)), start=1):
        cout = _divisible(int(bf * config["alpha"]))
        for bi in range(1, max(1, int(math.ceil(br * config["depth_multiplier"]))) + 1):
            name, s = f"stage{si}_ir{bi}", 2 if bi == 1 else 1
            y = _relu6(_bn(_conv(x, sd[f"{name}_expand.weight"], (1, 1), cast), sd,
                           f"{name}_expand_bn"))
            y = _relu6(_bn(_conv(y, sd[f"{name}_dw.weight"], (s, s), cast, y.shape[1]), sd,
                           f"{name}_dw_bn"))
            if config["use_se"]:
                g = torch.relu(_dense(y.mean(dim=(2, 3)), sd[f"{name}_se_reduce.weight"], cast))
                g = torch.sigmoid(_dense(g, sd[f"{name}_se_expand.weight"], cast))
                y = y * g[:, :, None, None]
            y = _bn(_conv(y, sd[f"{name}_project.weight"], (1, 1), cast), sd,
                    f"{name}_project_bn")
            x = x + y if s == 1 and cin == cout else y
            cin = cout
    if "emb_conv.weight" in sd:
        x = _relu6(_bn(_conv(x, sd["emb_conv.weight"], (1, 1), cast), sd, "emb_bn"))
    z = _dense(x.mean(dim=(2, 3)), sd["pred.weight"], cast) + sd["pred.bias"]
    return torch.sigmoid(z) if config["class_activation"] == "sigmoid" else torch.softmax(z, -1)
