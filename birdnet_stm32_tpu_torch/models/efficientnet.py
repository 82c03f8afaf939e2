"""EfficientNet-B1 audio classifier in PyTorch (Tan & Le, "EfficientNet:
Rethinking Model Scaling for Convolutional Neural Networks", ICML 2019,
arXiv:1905.11946), the backbone of Google's Perch bird-vocalization
classifier.

frontend -> stem 3x3 s2 to 32 channels -> BN -> SiLU -> 23 MBConv blocks
in 7 stages (models/blocks.py::mbconv_block: 1x1 expand, BN, SiLU; k x k
depthwise, BN, SiLU; squeeze-and-excite with biases on a quarter of the
block's input width; 1x1 project, BN; + input when the stride is 1 and the
widths match) -> 1x1 to 1280 -> BN -> SiLU -> global average -> dropout
-> dense head -> softmax, sigmoid or none (logits).

The widths and depths are B0's stage table (Table 1 of the paper, as
Keras's EfficientNet builds it) scaled by B1's compound-scaling
coefficients: width 1.0 (B0's widths stand), depth 1.1 (repeats 2, 3, 3,
4, 4, 5, 2, each B0 repeat count times 1.1 rounded up), dropout 0.2. Layers carry Keras's EfficientNetB1 names ('stem_conv',
'block2a_expand_conv', 'block2a_dwconv', 'block2a_bn', 'block2a_se_reduce',
..., 'top_conv', 'top_bn', 'predictions'). Convolutions pad as TF's
"SAME" (Conv2dSame), which equals Keras's `correct_pad` before its
stride-2 convolutions. BN is Keras's (eps 1e-3, momentum 0.99).

Departures from the paper, for audio:
- the input is a 1-channel spectrogram [B, mels, frames], not RGB, and the
  stem takes one channel;
- no ImageNet rescaling or normalisation layer;
- the port's in-graph audio frontend (the DS-CNN's, e.g. the hybrid mel
  mixer and pwl) sits in front of the stem;
- drop-connect (stochastic depth) is a training detail and is absent: the
  port serves the model in eval mode, where it is the identity.

Under bf16 serving every layer computes in bf16 but the head's
activation, which takes the logits in float32 (scores come out float32).

`.eval()` serves (BN on running statistics, dropout off). `self.blocks`
lists the MBConv blocks (23 for B1), the count a forward's mbconv.* spans
come in (utils/tracing.py). Public layout as the DS-CNN's: input
[B, bins, W, 1], scores [B, C]; NCHW inside.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.models.blocks import (
    Linear,
    add_conv_bn,
    add_mbconv_block,
    class_scores,
    mbconv_block,
)
from birdnet_stm32_tpu_torch.models.dscnn import CLASS_ACTIVATIONS
from birdnet_stm32_tpu_torch.models.frontend_layer import make_audio_frontend

# B0's stages: (kernel, repeats, input width, output width, expansion, stride).
B0_STAGES = ((3, 1, 32, 16, 1, 1), (3, 2, 16, 24, 6, 2), (5, 2, 24, 40, 6, 2),
             (3, 3, 40, 80, 6, 2), (5, 3, 80, 112, 6, 1), (5, 4, 112, 192, 6, 2),
             (3, 1, 192, 320, 6, 1))
STEM_WIDTH = 32
TOP_WIDTH = 1280
SE_RATIO = 0.25
# B1's compound-scaling coefficients beside width 1.0: depth, head dropout.
DEPTH = 1.1
DROPOUT = 0.2


@dataclass(frozen=True)
class MBConv:
    """One block of the stage table."""

    name: str
    cin: int
    cout: int
    kernel: int
    stride: int
    expansion: int

    @property
    def se_width(self) -> int:
        return max(1, int(self.cin * SE_RATIO))


def stage_table() -> tuple[MBConv, ...]:
    """B1's blocks in order, named as Keras names them (block1a, block1b,
    block2a, ...): the first block of a stage takes the stage's stride and
    input width, the others stride 1 at the output width."""
    out = []
    for si, (k, reps, cin, cout, e, s) in enumerate(B0_STAGES, start=1):
        for bi in range(math.ceil(DEPTH * reps)):
            out.append(MBConv(f"block{si}{chr(97 + bi)}", cin if bi == 0 else cout, cout, k,
                              s if bi == 0 else 1, e))
    return tuple(out)


class EfficientNet(nn.Module):
    """EfficientNet-B1 behind the port's in-graph audio frontend (module
    docstring)."""

    def __init__(self, cfg: ModelConfig, class_activation: str = "softmax"):
        super().__init__()
        if class_activation not in CLASS_ACTIVATIONS:
            raise ValueError(f"Invalid class_activation: {class_activation!r}")
        self.audio_frontend = make_audio_frontend(
            cfg.audio_frontend, cfg.num_mels, cfg.spec_width, cfg.sample_rate,
            cfg.chunk_duration, cfg.fft_length, cfg.mag_scale, cfg.n_mfcc)
        self.class_activation = class_activation
        add_conv_bn(self, "stem", 1, STEM_WIDTH, (3, 3), (2, 2))
        self.blocks = stage_table()
        for b in self.blocks:
            add_mbconv_block(self, b.name, b.cin, b.cout, b.kernel, (b.stride, b.stride),
                             b.expansion, SE_RATIO)
        add_conv_bn(self, "top", self.blocks[-1].cout, TOP_WIDTH, (1, 1), (1, 1))
        self.top_dropout = nn.Dropout(DROPOUT)
        self.predictions = Linear(TOP_WIDTH, cfg.num_classes)

    def forward(self, x: torch.Tensor, return_embeddings: bool = False):
        """[B, bins, W, 1] (raw: [B, T, 1]) -> [B, num_classes] float32
        scores (and the pooled [B, 1280] if asked)."""
        x = self.audio_frontend(x).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for b in self.blocks:
            x = mbconv_block(self, x, b.name)
        emb = F.silu(self.top_bn(self.top_conv(x))).mean(dim=(2, 3))
        # The head's activation in float32: in bf16 a score near 0.5 would
        # move in steps of 2^-8, more than the rest of the network's error.
        logits = self.predictions(self.top_dropout(emb)).float()
        y = class_scores(logits, self.class_activation)
        return (y, emb) if return_embeddings else y


def build_efficientnet(cfg: ModelConfig, class_activation: str = "softmax",
                       device: str | torch.device = "cuda") -> EfficientNet:
    """EfficientNet-B1 for `cfg`, in eval mode on `device` (default CUDA;
    raises if there is none). `cfg.architecture` must name it; its widths
    are B1's, so the DS-CNN's width knobs (alpha, depth_multiplier, use_se,
    ...) do not apply, and `cfg.embeddings_size` must state its pooled
    width, 1280. Its weights are the constructor's (torch's defaults; load
    a state_dict)."""
    if cfg.architecture != "efficientnet_b1":
        raise ValueError(f"architecture {cfg.architecture!r} is not 'efficientnet_b1'")
    if cfg.embeddings_size != TOP_WIDTH:
        raise ValueError(f"efficientnet_b1 pools {TOP_WIDTH} channels; the config states "
                         f"embeddings_size {cfg.embeddings_size}")
    return EfficientNet(cfg, class_activation).to(resolve_device(device)).eval()
