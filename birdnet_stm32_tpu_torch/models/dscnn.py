"""DS-CNN audio classifier in PyTorch (port of models/dscnn.py).

frontend -> stem 3x3 s(1,2) -> 4 stages of plain DS (or inverted-residual)
blocks with optional SE, base filters [32, 64, 128, 256] x alpha, repeats
[2, 3, 4, 2] x depth_multiplier (stride (2,2) on each stage's first block)
-> 1x1 embeddings conv_bn (skipped when the channels already match) -> GAP
or attention pooling -> dropout -> dense head -> softmax, sigmoid or none
(logits), as `class_activation` says.

`.eval()` serves (BN on running statistics, dropout off); `.train()` trains:
BN on batch statistics with the Keras running-statistics update, the
blocks' SpatialDropout2D and the head's dropout on. `train(freeze_bn=True)`
keeps every BN on its running statistics with no update (QAT), and
`train(freeze_frontend_bn=True)` only the frontend's (a frozen frontend).
Public layout as the JAX model: input [B, bins, W, 1] (or [B, T, 1] for
the raw frontend), scores [B, C]; NCHW inside.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.models.blocks import (
    Linear,
    add_attention_pooling,
    add_conv_bn,
    add_ds_conv_block,
    add_inverted_residual_block,
    add_se_block,
    attention_pooling,
    class_scores,
    conv_bn,
    ds_conv_block,
    inverted_residual_block,
    make_divisible,
    se_block,
)
from birdnet_stm32_tpu_torch.models.frontend_layer import make_audio_frontend

BASE_FILTERS: Sequence[int] = (32, 64, 128, 256)
BASE_REPEATS: Sequence[int] = (2, 3, 4, 2)
RAW_MAX_SAMPLES = 1 << 16  # N6 NPU constraint kept for config parity
CLASS_ACTIVATIONS = ("softmax", "sigmoid", "none")


class DSCNN(nn.Module):
    """DS-CNN with a selectable in-graph audio frontend.

    Layers carry the Keras names of the JAX model; `self.blocks` lists the
    (kind, name) of each block in order, and forward applies them.
    """

    def __init__(self, num_mels: int = 64, spec_width: int = 256,
                 sample_rate: int = 24000, chunk_duration: float = 3.0,
                 embeddings_size: int = 256,
                 num_classes: int = 100, audio_frontend: str = "hybrid",
                 alpha: float = 1.0, depth_multiplier: int = 1,
                 fft_length: int = 512, mag_scale: str = "pwl", n_mfcc: int = 20,
                 use_se: bool = True, se_reduction: int = 8,
                 use_inverted_residual: bool = True, expansion_factor: int = 2,
                 use_attention_pooling: bool = False, class_activation: str = "softmax",
                 learn_mel_scale: bool = False, dropout_rate: float = 0.5):
        super().__init__()
        if class_activation not in CLASS_ACTIVATIONS:
            raise ValueError(f"Invalid class_activation: {class_activation!r}")
        self.audio_frontend = make_audio_frontend(
            audio_frontend, num_mels, spec_width, sample_rate, chunk_duration, fft_length,
            mag_scale, n_mfcc, learn_mel_scale)
        self.use_attention_pooling = use_attention_pooling
        self.class_activation = class_activation

        blocks = []
        ch = add_conv_bn(self, "stem", 1, make_divisible(16 * alpha, 8), (3, 3), (1, 2))
        blocks.append(("conv_bn", "stem"))
        for si, (bf, br) in enumerate(zip(BASE_FILTERS, BASE_REPEATS), start=1):
            out_ch = make_divisible(int(bf * alpha), 8)
            reps = max(1, int(math.ceil(br * depth_multiplier)))
            for bi in range(1, reps + 1):
                strides = (2, 2) if bi == 1 else (1, 1)
                if use_inverted_residual:
                    name = f"stage{si}_ir{bi}"
                    ch = add_inverted_residual_block(self, name, ch, out_ch,
                                                     expansion_factor, strides,
                                                     use_se, se_reduction)
                    blocks.append(("ir", name))
                else:
                    name = f"stage{si}_ds{bi}"
                    ch = add_ds_conv_block(self, name, ch, out_ch, strides)
                    blocks.append(("ds", name))
                    if use_se:
                        add_se_block(self, f"stage{si}_se{bi}", ch, se_reduction)
                        blocks.append(("se", f"stage{si}_se{bi}"))
        emb_ch = make_divisible(embeddings_size, 8)
        if ch != emb_ch:
            ch = add_conv_bn(self, "emb", ch, emb_ch, (1, 1), (1, 1))
            blocks.append(("conv_bn", "emb"))
        if use_attention_pooling:
            add_attention_pooling(self, "attn_pool", ch)
        self.dropout = nn.Dropout(dropout_rate)
        self.pred = Linear(ch, num_classes)
        self.blocks = tuple(blocks)

    def train(self, mode: bool = True, freeze_bn: bool = False,
              freeze_frontend_bn: bool = False) -> "DSCNN":
        """Train mode (eval mode with mode=False); freeze_bn puts every BN
        back on its running statistics, freeze_frontend_bn the frontend's."""
        super().train(mode)
        if mode and (freeze_bn or freeze_frontend_bn):
            scope = self if freeze_bn else self.audio_frontend
            for m in scope.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor, return_embeddings: bool = False):
        """[B, bins, W, 1] (raw: [B, T, 1]) -> [B, num_classes] scores (and
        [B, emb] if asked)."""
        x = self.audio_frontend(x).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for kind, name in self.blocks:
            if kind == "conv_bn":
                x = conv_bn(self, x, name)
            elif kind == "ds":
                x = ds_conv_block(self, x, name)
            elif kind == "ir":
                x = inverted_residual_block(self, x, name)
            else:
                x = se_block(self, x, name)
        if self.use_attention_pooling:
            emb = attention_pooling(self, x, "attn_pool")
        else:
            emb = x.mean(dim=(2, 3))  # GAP
        y = class_scores(self.pred(self.dropout(emb)), self.class_activation)
        return (y, emb) if return_embeddings else y


def build_dscnn(cfg: ModelConfig, class_activation: str = "softmax",
                learn_mel_scale: bool = False,
                device: str | torch.device = "cuda") -> DSCNN:
    """A DSCNN for `cfg`, in eval mode on `device` (default CUDA; raises if
    there is none). Its weights are the constructor's: load a state_dict
    (models/convert.py) or call init_model. The raw frontend takes fewer
    than RAW_MAX_SAMPLES samples, as the reference's deployment does."""
    if cfg.audio_frontend == "raw" and cfg.chunk_samples >= RAW_MAX_SAMPLES:
        raise ValueError(
            f"raw frontend input length ({cfg.chunk_samples}) must be < {RAW_MAX_SAMPLES} "
            "for reference deployment parity; lower sample_rate or chunk_duration.")
    dev = resolve_device(device)
    model = DSCNN(
        num_mels=cfg.num_mels,
        spec_width=cfg.spec_width,
        sample_rate=cfg.sample_rate,
        chunk_duration=cfg.chunk_duration,
        embeddings_size=cfg.embeddings_size,
        num_classes=cfg.num_classes,
        audio_frontend=cfg.audio_frontend,
        alpha=cfg.alpha,
        depth_multiplier=cfg.depth_multiplier,
        fft_length=cfg.fft_length,
        mag_scale=cfg.mag_scale,
        n_mfcc=cfg.n_mfcc,
        use_se=cfg.use_se,
        se_reduction=cfg.se_reduction,
        use_inverted_residual=cfg.use_inverted_residual,
        expansion_factor=cfg.expansion_factor,
        use_attention_pooling=cfg.use_attention_pooling,
        class_activation=class_activation,
        learn_mel_scale=learn_mel_scale,
        dropout_rate=cfg.dropout_rate,
    )
    return model.to(dev).eval()


@torch.no_grad()
def init_model(model: DSCNN, seed: int = 0) -> DSCNN:
    """Seeded random weights, the same on every device.

    Conv and dense weights are drawn on the CPU from one torch.Generator:
    He-normal for convolutions (the raw filterbank's too, so activations
    keep their scale through the ReLU6 stack and the scores are not all
    equal), LeCun-normal for dense layers. Biases are zero; BN, the mel
    mixer or segment logits and the magnitude scaling keep their
    constructor values (identity BN, Slaney mixer, default curves).
    """
    g = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()
            gain = 1.0 if isinstance(module, nn.Linear) else 2.0
            w.copy_(torch.randn(w.shape, generator=g) * math.sqrt(gain / fan_in))
            if module.bias is not None:
                module.bias.zero_()
    return model
