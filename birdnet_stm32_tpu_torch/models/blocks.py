"""DS-CNN building blocks in PyTorch (port of models/blocks.py).

Layouts are NCHW inside the model (H = frequency bins, W = frames, as the
JAX package's NHWC H and W). Every weighted layer registers directly on the
parent model under its exact Keras layer name ('stem_conv',
'stage1_ds1_dw_bn', ...), as the Flax blocks do, so that converting Flax
variables (models/convert.py) is a flat rename. Each block therefore comes
as a pair: `add_<block>(parent, name, ...)` registers its layers and
returns the channel count it produces; `<block>(parent, x, name, ...)`
applies them.

Train mode is the module's `.train()`: BN normalises with the batch
statistics and updates its running statistics the Keras / Flax way (with
the biased batch variance), and the blocks' SpatialDropout2D drops whole
channels. `.eval()` serves: BN on its running statistics, dropout off.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

# Keras BatchNormalization defaults, which the whole reference model uses
# (torch's momentum is 1 - Keras momentum).
BN_MOMENTUM = 0.99
BN_EPS = 1e-3
# The blocks' SpatialDropout2D rate (fixed in the reference's blocks).
BLOCK_DROP_RATE = 0.1


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round a channel count to the nearest multiple of `divisor` (min = divisor)."""
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of Flax/TF "SAME" for size n, kernel k, stride s.

    SAME pads asymmetrically: for k=3, s=2 and an even n it pads (0, 1),
    which neither torch's `padding=1` nor `padding="same"` reproduces.
    """
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Bias-free Conv2d with Flax "SAME" padding, applied explicitly."""

    def __init__(self, cin: int, cout: int, kernel, strides=(1, 1), groups: int = 1):
        super().__init__(cin, cout, kernel, stride=strides, padding=0,
                         groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        hl, hh = same_pads(x.shape[2], kh, sh)
        wl, wh = same_pads(x.shape[3], kw, sw)
        if hl or hh or wl or wh:
            x = F.pad(x, (wl, wh, hl, hh))
        return super().forward(x)


class _KerasBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm whose train mode updates the running variance with the
    biased batch variance, as Keras and Flax do (torch's BatchNorm uses the
    unbiased one, n / (n - 1) larger). In eval mode it is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x.detach(), dim=dims, correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm1d(_KerasBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_KerasBatchNorm, nn.BatchNorm2d):
    pass


def batch_norm(channels: int) -> BatchNorm2d:
    """Keras-default BatchNormalization (momentum .99, eps 1e-3)."""
    return BatchNorm2d(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)


def depthwise_conv(channels: int, strides) -> Conv2dSame:
    """3x3 depthwise conv (multiplier 1), matching Keras DepthwiseConv2D."""
    return Conv2dSame(channels, channels, (3, 3), strides, groups=channels)


def add_conv_bn(parent: nn.Module, name: str, cin: int, cout: int, kernel,
                strides) -> int:
    """Conv2D (no bias, SAME) + BN: layers '<name>_conv' and '<name>_bn'."""
    parent.add_module(f"{name}_conv", Conv2dSame(cin, cout, kernel, strides))
    parent.add_module(f"{name}_bn", batch_norm(cout))
    return cout


def conv_bn(parent: nn.Module, x: torch.Tensor, name: str, act: bool = True) -> torch.Tensor:
    x = getattr(parent, f"{name}_bn")(getattr(parent, f"{name}_conv")(x))
    return relu6(x) if act else x


def add_ds_conv_block(parent: nn.Module, name: str, cin: int, cout: int, strides) -> int:
    """DW 3x3 -> BN -> ReLU6 -> PW 1x1 -> BN (reference dscnn.py:28-84)."""
    parent.add_module(f"{name}_dw", depthwise_conv(cin, strides))
    parent.add_module(f"{name}_dw_bn", batch_norm(cin))
    parent.add_module(f"{name}_pw", Conv2dSame(cin, cout, (1, 1)))
    parent.add_module(f"{name}_pw_bn", batch_norm(cout))
    parent.add_module(f"{name}_drop", nn.Dropout2d(BLOCK_DROP_RATE))
    return cout


def ds_conv_block(parent: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    """DW -> BN -> ReLU6 -> PW -> BN -> SpatialDropout -> (+x when stride 1
    and in == out) -> ReLU6."""
    dw = getattr(parent, f"{name}_dw")
    y = relu6(getattr(parent, f"{name}_dw_bn")(dw(x)))
    y = getattr(parent, f"{name}_pw_bn")(getattr(parent, f"{name}_pw")(y))
    y = getattr(parent, f"{name}_drop")(y)
    if tuple(dw.stride) == (1, 1) and y.shape[1] == x.shape[1]:
        y = x + y
    return relu6(y)


def add_se_block(parent: nn.Module, name: str, channels: int, reduction: int = 8) -> int:
    """Squeeze-and-Excite: '<name>_reduce' and '<name>_expand' dense layers."""
    se_ch = max(1, channels // reduction)
    parent.add_module(f"{name}_reduce", nn.Linear(channels, se_ch, bias=False))
    parent.add_module(f"{name}_expand", nn.Linear(se_ch, channels, bias=False))
    return channels


def se_block(parent: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    s = torch.relu(getattr(parent, f"{name}_reduce")(x.mean(dim=(2, 3))))
    s = torch.sigmoid(getattr(parent, f"{name}_expand")(s))
    return x * s[:, :, None, None]


def add_inverted_residual_block(parent: nn.Module, name: str, cin: int, cout: int,
                                expansion: int, strides, use_se: bool,
                                se_reduction: int) -> int:
    """1x1 expand -> BN/ReLU6 -> DW 3x3 -> BN/ReLU6 -> [SE] -> 1x1 project
    -> BN -> SpatialDropout (reference blocks.py:49-133)."""
    hidden = make_divisible(cin * expansion, 8)
    parent.add_module(f"{name}_expand", Conv2dSame(cin, hidden, (1, 1)))
    parent.add_module(f"{name}_expand_bn", batch_norm(hidden))
    parent.add_module(f"{name}_dw", depthwise_conv(hidden, strides))
    parent.add_module(f"{name}_dw_bn", batch_norm(hidden))
    if use_se:
        add_se_block(parent, f"{name}_se", hidden, se_reduction)
    parent.add_module(f"{name}_project", Conv2dSame(hidden, cout, (1, 1)))
    parent.add_module(f"{name}_project_bn", batch_norm(cout))
    parent.add_module(f"{name}_drop", nn.Dropout2d(BLOCK_DROP_RATE))
    return cout


def inverted_residual_block(parent: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    y = relu6(getattr(parent, f"{name}_expand_bn")(getattr(parent, f"{name}_expand")(x)))
    dw = getattr(parent, f"{name}_dw")
    y = relu6(getattr(parent, f"{name}_dw_bn")(dw(y)))
    if hasattr(parent, f"{name}_se_reduce"):
        y = se_block(parent, y, f"{name}_se")
    y = getattr(parent, f"{name}_project_bn")(getattr(parent, f"{name}_project")(y))
    y = getattr(parent, f"{name}_drop")(y)
    if tuple(dw.stride) == (1, 1) and y.shape[1] == x.shape[1]:
        y = x + y
    return y


def add_attention_pooling(parent: nn.Module, name: str, channels: int) -> int:
    parent.add_module(f"{name}_score", nn.Linear(channels, 1, bias=False))
    return channels


def attention_pooling(parent: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    """Learned weighted average over spatial positions: [B, C, H, W] -> [B, C]."""
    flat = x.flatten(2).transpose(1, 2)  # [B, HW, C]
    attn = torch.softmax(getattr(parent, f"{name}_score")(flat), dim=1)
    return (flat * attn).sum(dim=1)
