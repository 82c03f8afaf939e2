"""DS-CNN and EfficientNet building blocks in PyTorch (port of
models/blocks.py; the MBConv pair is the port's own).

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

Dtypes follow Flax's layers (dtype=None): each layer computes in the result
type of its input and its parameters, so a float32 input meeting bf16
parameters computes in float32 (`promote`). BN computes its batch
statistics in float32 whatever its input.

The activation fake-quant hook (quant/fake_quant.py::activation_fake_quant)
is a ContextVar: while it is set, every hookable relu6 output runs through
it. The raw frontend's relu6 opts out.
"""

from __future__ import annotations

import contextvars
import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from birdnet_stm32_tpu_torch.parallel import distributed
from birdnet_stm32_tpu_torch.utils.tracing import (
    MBCONV_DW,
    MBCONV_EXPAND,
    MBCONV_PROJECT,
    MBCONV_SE,
    span,
)

# Keras BatchNormalization defaults, which the whole reference model uses
# (torch's momentum is 1 - Keras momentum).
BN_MOMENTUM = 0.99
BN_EPS = 1e-3
# The blocks' SpatialDropout2D rate (fixed in the reference's blocks).
BLOCK_DROP_RATE = 0.1


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round a channel count to the nearest multiple of `divisor` (min = divisor)."""
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


# Set by quant/fake_quant.py::activation_fake_quant: a function applied to
# every hookable relu6 output (the QAT step's activation fake-quant).
ACT_FQ: contextvars.ContextVar = contextvars.ContextVar("act_fq", default=None)


class _ReLU6(torch.autograd.Function):
    """clamp(x, 0, 6) (one launch) with the gradient of JAX's
    min(max(x, 0), 6): half the incoming gradient where x is exactly 0 or
    6 (torch.clamp passes all of it). The activation fake-quant makes such
    ties: a window of zeroed codes gives a pre-activation of exactly 0."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 6.0)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        # (sign(x) - sign(x - 6)) / 2: 0 outside [0, 6], 1 inside, 1/2 at 0 and 6.
        return g * ((torch.sign(x) - torch.sign(x - 6.0)) * 0.5)


def relu6(x: torch.Tensor, hookable: bool = True) -> torch.Tensor:
    """ReLU6; hookable=False opts a call site out of the activation
    fake-quant hook (the frontend's)."""
    y = _ReLU6.apply(x)
    fq = ACT_FQ.get() if hookable else None
    return fq(y) if fq is not None else y


def promote(x: torch.Tensor, *params: torch.Tensor | None) -> list:
    """x and params cast to their result dtype (None stays None), as a Flax
    layer with dtype=None computes. A cast happens only where the dtypes
    differ."""
    dt = functools.reduce(torch.promote_types,
                          (p.dtype for p in params if p is not None), x.dtype)
    return [t if t is None or t.dtype == dt else t.to(dt) for t in (x, *params)]


class Linear(nn.Linear):
    """nn.Linear computing in the result dtype of its input and weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promote(x, self.weight, self.bias))


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
        return self._conv_forward(*promote(x, self.weight), None)


class _KerasBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm whose train mode updates the running variance with the
    biased batch variance, as Keras and Flax do (torch's BatchNorm uses the
    unbiased one, n / (n - 1) larger), from float32 batch statistics.

    As Flax's: the output has the result dtype of the input, scale and
    bias. Train mode normalises in float32 at least and rounds once (Flax's
    batch statistics are float32, and x - mean promotes); eval mode in the
    result dtype of all five tensors (float32 running statistics under bf16
    parameters normalise in float32). torch's batch_norm with bf16 scale
    and bias rounds between its steps and differs from Flax's train mode
    in about half the outputs.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = promote(x, self.weight, self.bias)[0].dtype
        if not self.training:
            xx, w, b, mean, var = promote(x, self.weight, self.bias,
                                          self.running_mean, self.running_var)
            return F.batch_norm(xx, mean, var, w, b, False, 0.0, self.eps).to(out_dtype)
        # float32 scale and bias under a bf16 input: torch's mixed-type
        # batch_norm, which computes in float32 and rounds once.
        w, b = (t.to(torch.promote_types(t.dtype, torch.float32))
                for t in (self.weight, self.bias))
        dims = [0, *range(2, x.dim())]
        if distributed.host_shard()[1] > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, w, b, self.eps)
            y = y.to(out_dtype)
        else:
            y = F.batch_norm(x.to(out_dtype), None, None, w, b, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.detach().float(), dim=dims, correction=0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean)
            self.running_var.mul_(keep).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN over the union of every rank's rows (the global batch
    of the JAX package's data-parallel step; SyncBatchNorm's semantics), in
    float32. Forward: the channel sums, the row count and the centred
    squares are all-reduced (two passes), y = (x - mean) * invstd * w + b.
    Backward: torch's batch-norm gradient with the sums of dy and of
    dy * (x - mean) all-reduced; the scale's and bias's gradients stay this
    rank's (the step averages every gradient over the ranks). Returns
    (output, batch mean, biased batch variance)."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        sums = torch.cat([xf.sum(dims), xf.new_tensor([x.numel() // x.shape[1]])])
        distributed.all_reduce_sum_(sums)
        count = sums[-1]
        mean = sums[:-1] / count
        xmu = xf - mean.view(shape)
        sq = (xmu * xmu).sum(dims)
        distributed.all_reduce_sum_(sq)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        y = xmu * (invstd * w).view(shape) + b.view(shape)
        ctx.save_for_backward(xmu, invstd, w, count)
        ctx.dims, ctx.shape, ctx.in_dtype = dims, shape, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xmu, invstd, w, count = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xmu = (dyf * xmu).sum(dims)
        grad_w, grad_b = sum_dy_xmu * invstd, sum_dy.clone()
        sums = torch.cat([sum_dy, sum_dy_xmu])
        distributed.all_reduce_sum_(sums)
        mean_dy, mean_dy_xmu = (sums / count).chunk(2)
        dx = (dyf - mean_dy.view(shape) - xmu * (invstd * invstd * mean_dy_xmu).view(shape)) \
            * (invstd * w).view(shape)
        return dx.to(ctx.in_dtype), grad_w.to(w.dtype), grad_b.to(w.dtype), None


class BatchNorm1d(_KerasBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_KerasBatchNorm, nn.BatchNorm2d):
    pass


def batch_norm(channels: int) -> BatchNorm2d:
    """Keras-default BatchNormalization (momentum .99, eps 1e-3)."""
    return BatchNorm2d(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)


def depthwise_conv(channels: int, strides, kernel: int = 3) -> Conv2dSame:
    """kernel x kernel depthwise conv (multiplier 1), matching Keras
    DepthwiseConv2D."""
    return Conv2dSame(channels, channels, (kernel, kernel), strides, groups=channels)


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


def add_se_block(parent: nn.Module, name: str, channels: int, reduction: int = 8,
                 squeeze: int | None = None, bias: bool = False) -> int:
    """Squeeze-and-Excite: '<name>_reduce' and '<name>_expand' dense layers
    through `squeeze` channels (default channels // reduction, at least 1),
    with biases if `bias` (EfficientNet's)."""
    se_ch = squeeze or max(1, channels // reduction)
    parent.add_module(f"{name}_reduce", Linear(channels, se_ch, bias=bias))
    parent.add_module(f"{name}_expand", Linear(se_ch, channels, bias=bias))
    return channels


def se_block(parent: nn.Module, x: torch.Tensor, name: str, act=torch.relu) -> torch.Tensor:
    """x times sigmoid(expand(act(reduce(mean of x over H, W)))), per channel."""
    s = act(getattr(parent, f"{name}_reduce")(x.mean(dim=(2, 3))))
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


def add_mbconv_block(parent: nn.Module, name: str, cin: int, cout: int, kernel: int,
                     strides, expansion: int, se_ratio: float) -> int:
    """Keras EfficientNet's MBConv block, its layers under Keras's names:
    1x1 expand '<name>_expand_conv' -> BN '<name>_expand_bn' -> SiLU (only
    when expansion > 1) -> kernel x kernel depthwise '<name>_dwconv' -> BN
    '<name>_bn' -> SiLU -> SE ('<name>_se_reduce', '<name>_se_expand', with
    biases, through max(1, int(cin * se_ratio)) channels of the block's
    input width) -> 1x1 project '<name>_project_conv' -> BN
    '<name>_project_bn'."""
    hidden = cin * expansion
    if expansion != 1:
        parent.add_module(f"{name}_expand_conv", Conv2dSame(cin, hidden, (1, 1)))
        parent.add_module(f"{name}_expand_bn", batch_norm(hidden))
    parent.add_module(f"{name}_dwconv", depthwise_conv(hidden, strides, kernel))
    parent.add_module(f"{name}_bn", batch_norm(hidden))
    add_se_block(parent, f"{name}_se", hidden, squeeze=max(1, int(cin * se_ratio)), bias=True)
    parent.add_module(f"{name}_project_conv", Conv2dSame(hidden, cout, (1, 1)))
    parent.add_module(f"{name}_project_bn", batch_norm(cout))
    parent._opens_spans = True  # mbconv_block's spans: see opens_spans
    return cout


def opens_spans(model: nn.Module) -> bool:
    """True when a forward of `model` opens program spans of its own, which
    a CUDA graph's replay would launch every kernel outside of: it holds an
    MBConv block (add_mbconv_block marks its parent), whose mbconv_block
    records the mbconv.* spans (models/runners.py::TorchRunner keeps such a
    model eager)."""
    return any(getattr(m, "_opens_spans", False) for m in model.modules())


def mbconv_block(parent: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    """The MBConv block (+ x when the stride is 1 and the widths match).
    While a profiler records, the expand, depthwise and project convolution
    calls and the whole SE each lie in a span (utils/tracing.py); BN, SiLU
    and the residual add stay outside them."""
    y = x
    if hasattr(parent, f"{name}_expand_conv"):
        with span(MBCONV_EXPAND):
            y = getattr(parent, f"{name}_expand_conv")(y)
        y = F.silu(getattr(parent, f"{name}_expand_bn")(y))
    dw = getattr(parent, f"{name}_dwconv")
    with span(MBCONV_DW):
        y = dw(y)
    y = F.silu(getattr(parent, f"{name}_bn")(y))
    with span(MBCONV_SE):
        y = se_block(parent, y, f"{name}_se", act=F.silu)
    with span(MBCONV_PROJECT):
        y = getattr(parent, f"{name}_project_conv")(y)
    y = getattr(parent, f"{name}_project_bn")(y)
    if tuple(dw.stride) == (1, 1) and y.shape[1] == x.shape[1]:
        y = x + y
    return y


def class_scores(logits: torch.Tensor, class_activation: str) -> torch.Tensor:
    """The head's activation: 'softmax', 'sigmoid' or 'none' (logits)."""
    if class_activation == "softmax":
        return torch.softmax(logits, dim=-1)
    if class_activation == "sigmoid":
        return torch.sigmoid(logits)
    return logits


def add_attention_pooling(parent: nn.Module, name: str, channels: int) -> int:
    parent.add_module(f"{name}_score", Linear(channels, 1, bias=False))
    return channels


def attention_pooling(parent: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    """Learned weighted average over spatial positions: [B, C, H, W] -> [B, C]."""
    flat = x.flatten(2).transpose(1, 2)  # [B, HW, C]
    attn = torch.softmax(getattr(parent, f"{name}_score")(flat), dim=1)
    return (flat * attn).sum(dim=1)
