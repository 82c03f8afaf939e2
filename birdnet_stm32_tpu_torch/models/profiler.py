"""Analytical model profiler: per-layer params, MACs, activation bytes
(port of models/profiler.py).

The cost table, totals, INT8 / float32 size estimates and the STM32N6
compatibility warnings, computed from the ModelConfig by walking the
architecture the port's DS-CNN builder makes (its BASE_FILTERS,
BASE_REPEATS and make_divisible); nothing is traced. Pure Python.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.blocks import make_divisible
from birdnet_stm32_tpu_torch.models.dscnn import BASE_FILTERS, BASE_REPEATS

# Ops the STM32N6 Neural-ART deployment target supports / warns on; kept
# for export compatibility checks.
N6_SUPPORTED_OPS = frozenset({
    "Conv2D", "DepthwiseConv2D", "Dense", "BatchNormalization", "ReLU",
    "Add", "Multiply", "GlobalAveragePooling2D", "AveragePooling2D",
    "MaxPooling2D", "Softmax", "Sigmoid", "Concatenate", "Reshape",
})
N6_WARN_OPS = frozenset({"Log", "Exp", "Pow", "Div", "Softplus"})


@dataclass
class LayerCost:
    name: str
    kind: str
    out_shape: tuple
    params: int
    macs: int
    act_bytes: int
    n6_ok: bool = True


def _conv_cost(name, h, w, cin, cout, kh, kw, groups=1) -> LayerCost:
    per_pos = kh * kw * (cin // groups) * cout
    return LayerCost(name, "Conv2D" if groups == 1 else "DepthwiseConv2D",
                     (h, w, cout), kh * kw * (cin // groups) * cout,
                     per_pos * h * w, h * w * cout * 4)


def _bn_cost(name, h, w, c) -> LayerCost:
    return LayerCost(name, "BatchNormalization", (h, w, c), 2 * c, h * w * c, h * w * c * 4)


def profile_model(cfg: ModelConfig) -> list[LayerCost]:
    """Per-layer cost rows for the configured DS-CNN (frontend included)."""
    rows: list[LayerCost] = []
    M = cfg.num_mels
    W = cfg.spec_width

    # Frontend
    if cfg.audio_frontend == "hybrid":
        F = cfg.fft_bins
        rows.append(_conv_cost("audio_frontend.mel_mixer", 1, W, F, M, 1, 1))
        rows.append(LayerCost("audio_frontend.mag", "Multiply", (M, W, 1),
                              10 * M if cfg.mag_scale == "pwl" else 5 * M if cfg.mag_scale == "pcen" else 0,
                              4 * M * W, M * W * 4, cfg.mag_scale != "db"))
    elif cfg.audio_frontend == "raw":
        rows.append(_conv_cost("audio_frontend.raw_fb", 1, W, 1, M, 1, 16))
        rows.append(_bn_cost("audio_frontend.raw_fb_bn", 1, W, M))
        # Raw applies the magnitude scaling after the filterbank BN too
        # (models/frontend_layer.py): 10*M params for pwl, 5*M for pcen.
        rows.append(LayerCost("audio_frontend.mag", "Multiply", (M, W, 1),
                              10 * M if cfg.mag_scale == "pwl" else 5 * M if cfg.mag_scale == "pcen" else 0,
                              4 * M * W, M * W * 4, cfg.mag_scale != "db"))

    h, w = (cfg.n_mfcc if cfg.audio_frontend == "mfcc" else M), W

    def ceil_div(a, b):
        return -(-a // b)

    # Stem 3x3 s(1,2)
    stem_ch = make_divisible(16 * cfg.alpha, 8)
    w2 = ceil_div(w, 2)
    rows.append(_conv_cost("stem_conv", h, w2, 1, stem_ch, 3, 3))
    rows.append(_bn_cost("stem_bn", h, w2, stem_ch))
    cin, w = stem_ch, w2

    for si, (bf, br) in enumerate(zip(BASE_FILTERS, BASE_REPEATS), start=1):
        out_ch = make_divisible(int(bf * cfg.alpha), 8)
        reps = max(1, int(math.ceil(br * cfg.depth_multiplier)))
        for bi in range(1, reps + 1):
            s = 2 if bi == 1 else 1
            h_in, w_in = h, w  # pre-stride dims (h*s would overcount odd sizes)
            h, w = ceil_div(h, s), ceil_div(w, s)
            n = f"stage{si}_{'ir' if cfg.use_inverted_residual else 'ds'}{bi}"
            if cfg.use_inverted_residual:
                hidden = make_divisible(cin * cfg.expansion_factor, 8)
                rows.append(_conv_cost(f"{n}_expand", h_in, w_in, cin, hidden, 1, 1))
                rows.append(_bn_cost(f"{n}_expand_bn", h_in, w_in, hidden))
                rows.append(_conv_cost(f"{n}_dw", h, w, hidden, hidden, 3, 3, groups=hidden))
                rows.append(_bn_cost(f"{n}_dw_bn", h, w, hidden))
                if cfg.use_se:
                    se_ch = max(1, hidden // cfg.se_reduction)
                    rows.append(LayerCost(f"{n}_se", "Dense", (1, 1, hidden),
                                          hidden * se_ch * 2, hidden * se_ch * 2, hidden * 4))
                rows.append(_conv_cost(f"{n}_project", h, w, hidden, out_ch, 1, 1))
                rows.append(_bn_cost(f"{n}_project_bn", h, w, out_ch))
            else:
                rows.append(_conv_cost(f"{n}_dw", h, w, cin, cin, 3, 3, groups=cin))
                rows.append(_bn_cost(f"{n}_dw_bn", h, w, cin))
                rows.append(_conv_cost(f"{n}_pw", h, w, cin, out_ch, 1, 1))
                rows.append(_bn_cost(f"{n}_pw_bn", h, w, out_ch))
                if cfg.use_se:
                    se_ch = max(1, out_ch // cfg.se_reduction)
                    rows.append(LayerCost(f"stage{si}_se{bi}", "Dense", (1, 1, out_ch),
                                          out_ch * se_ch * 2, out_ch * se_ch * 2, out_ch * 4))
            cin = out_ch

    emb_ch = make_divisible(cfg.embeddings_size, 8)
    if cin != emb_ch:
        rows.append(_conv_cost("emb_conv", h, w, cin, emb_ch, 1, 1))
        rows.append(_bn_cost("emb_bn", h, w, emb_ch))
        cin = emb_ch

    if cfg.use_attention_pooling:
        rows.append(LayerCost("attn_pool", "Dense", (cin,), cin, h * w * cin, cin * 4))
    rows.append(LayerCost("pred", "Dense", (cfg.num_classes,),
                          cin * cfg.num_classes + cfg.num_classes,
                          cin * cfg.num_classes, cfg.num_classes * 4))
    return rows


def totals(rows: list[LayerCost]) -> dict:
    p = sum(r.params for r in rows)
    return {
        "params": p,
        "macs": sum(r.macs for r in rows),
        # The sum of the per-layer activation buffers;
        # peak_activation_bytes is the largest single buffer.
        "activation_bytes": sum(r.act_bytes for r in rows),
        "peak_activation_bytes": max((r.act_bytes for r in rows), default=0),
        "size_float32_bytes": p * 4,
        "size_int8_bytes": p,
    }


def print_profile(cfg: ModelConfig) -> dict:
    """Print the cost table and return the totals."""
    rows = profile_model(cfg)
    print(f"{'layer':32s} {'type':20s} {'out shape':16s} {'params':>10s} {'MACs':>12s}")
    for r in rows:
        print(f"{r.name:32s} {r.kind:20s} {str(r.out_shape):16s} {r.params:>10,} {r.macs:>12,}")
    t = totals(rows)
    print(f"\nTotal params: {t['params']:,}  MACs: {t['macs']:,}")
    print(f"Activation memory: {t['activation_bytes'] / 1024:.1f} KB (float32, "
          f"sum of layer outputs; peak single buffer "
          f"{t['peak_activation_bytes'] / 1024:.1f} KB)")
    print(f"Est. size: float32 {t['size_float32_bytes']:,} B, INT8 {t['size_int8_bytes']:,} B")
    return t


def check_n6_compatibility(cfg: ModelConfig) -> list[str]:
    """STM32N6 deployment warnings."""
    warnings = []
    if cfg.audio_frontend == "raw" and cfg.chunk_samples >= (1 << 16):
        warnings.append(f"raw input length {cfg.chunk_samples} >= 65536 (N6 limit)")
    if cfg.mag_scale == "db":
        warnings.append("mag_scale 'db' uses Log — unsupported on the N6 NPU and hostile to PTQ")
    return warnings
