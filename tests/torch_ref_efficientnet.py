"""EfficientNet-B1 written out in plain torch float32, the port's tests'
reference (Tan & Le, "EfficientNet: Rethinking Model Scaling for
Convolutional Neural Networks", ICML 2019, arXiv:1905.11946, Table 1 at
B1's width 1.0 and depth 1.1; layer for layer as Keras's EfficientNetB1,
in eval mode). It imports neither birdnet package nor JAX, and turns TF32
off while it runs on a GPU.

[B, 1, H, W] spectrogram -> stem 3x3 stride 2 to 32 -> BN -> SiLU -> the
23 MBConv blocks of BLOCKS -> 1x1 to 1280 -> BN -> SiLU -> global average
-> dense -> logits. An MBConv block: 1x1 expand (expansion 6; none at 1)
-> BN -> SiLU -> k x k depthwise -> BN -> SiLU -> squeeze-and-excite
(mean over H, W -> dense with bias to max(1, int(input width / 4)) ->
SiLU -> dense with bias -> sigmoid -> product) -> 1x1 project -> BN (+ the
block's input when its stride is 1 and its widths match). "SAME" padding,
BN eps 1e-3.

Departures from the paper: one input channel (a spectrogram, not RGB) and
no rescaling layer; no drop-connect and no dropout (eval mode). The port's
audio frontend, in front of the stem there, is not part of this file:
callers feed it the frontend's output.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-3
# B1's blocks, stage by stage: (repeats, kernel, input width, output
# width, expansion, first stride). B0's repeats 1, 2, 2, 3, 3, 4, 1 times
# depth 1.1, rounded up; widths at width 1.0 are B0's.
B1_STAGES = ((2, 3, 32, 16, 1, 1), (3, 3, 16, 24, 6, 2), (3, 5, 24, 40, 6, 2),
             (4, 3, 40, 80, 6, 2), (4, 5, 80, 112, 6, 1), (5, 5, 112, 192, 6, 2),
             (2, 3, 192, 320, 6, 1))
BLOCKS = [(f"block{si}{'abcde'[bi]}", cin if bi == 0 else cout, cout, k, s if bi == 0 else 1, e)
          for si, (reps, k, cin, cout, e, s) in enumerate(B1_STAGES, start=1)
          for bi in range(reps)]


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuBLAS and cuDNN for the block, as a float32 reference
    needs on a GPU."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def conv_same(x, w, stride=1, groups=1):
    """Conv2d with TensorFlow's "SAME" padding (the low side gets the
    smaller half)."""
    pads = []
    for n, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride, groups=groups)


def bn(x, p, name):
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + EPS)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def dense(x, p, name):
    return x @ p[f"{name}.weight"].T + p[f"{name}.bias"]


@torch.no_grad()
def logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] float32 -> [B, classes] float32 logits under the
    weights `p` (Keras layer name -> float32 tensor)."""
    with no_tf32():
        x = F.silu(bn(conv_same(x, p["stem_conv.weight"], 2), p, "stem_bn"))
        for name, cin, cout, k, s, e in BLOCKS:
            y = x
            if e > 1:
                y = F.silu(bn(conv_same(y, p[f"{name}_expand_conv.weight"]), p,
                              f"{name}_expand_bn"))
            y = F.silu(bn(conv_same(y, p[f"{name}_dwconv.weight"], s, cin * e), p,
                          f"{name}_bn"))
            g = F.silu(dense(y.mean(dim=(2, 3)), p, f"{name}_se_reduce"))
            y = y * torch.sigmoid(dense(g, p, f"{name}_se_expand"))[:, :, None, None]
            y = bn(conv_same(y, p[f"{name}_project_conv.weight"]), p, f"{name}_project_bn")
            x = y + x if s == 1 and cin == cout else y
        x = F.silu(bn(conv_same(x, p["top_conv.weight"]), p, "top_bn"))
        return dense(x.mean(dim=(2, 3)), p, "predictions")
