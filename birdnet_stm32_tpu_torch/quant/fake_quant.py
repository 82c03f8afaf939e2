"""INT8 fake-quantization with straight-through gradients (port of
quant/fake_quant.py).

Asymmetric min/max affine quantize-dequantize to 2^bits - 1 levels,
per-channel over the output-channel axis (axis 0 in the port's layouts:
Conv [O, I, kh, kw], depthwise [C, 1, kh, kw], Linear [out, in]) or
per-tensor, with round-half-to-even. The straight-through estimator is a
torch.autograd.Function whose forward returns the quantized tensor itself
and whose backward passes the gradient to the float weights unchanged.

The arithmetic is the jitted JAX function's, bit for bit: XLA turns the
division by 2^bits - 1 into a multiply by its float32 reciprocal, keeps
the division by the per-channel scale a true division, and contracts
round(.) * scale + w_min into one fused multiply-add. The port writes the
reciprocal out and computes the multiply-add in float64, where
round(.) * scale is exact, so one rounding to float32 follows (the fused
result; the two differ only if w_min is nonzero and below 2^-29 of the
product, when the float64 sum would round first). Every operation is
correctly rounded on the CPU and on CUDA, so both give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from birdnet_stm32_tpu_torch.models import blocks


class _STE(torch.autograd.Function):
    """Forward: the quantized tensor; backward: the identity to the float
    tensor (nothing to the quantized one)."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
        return wq

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def _inv_levels(num_bits: int) -> float:
    """float32(1 / (2^bits - 1)), the multiplier XLA uses for the division."""
    return float(np.float32(1.0) / np.float32((1 << num_bits) - 1))


@torch.no_grad()
def fake_quantize(w: torch.Tensor, num_bits: int = 8, per_channel: bool = True,
                  channel_axis: int = 0) -> torch.Tensor:
    """Quantize-dequantize a weight tensor (no gradient).

    per_channel: ranges per index of `channel_axis` (tensors of one
    dimension take the per-tensor range), else one range for the tensor.
    """
    if per_channel and w.ndim > 1:
        dims = [i for i in range(w.ndim) if i != channel_axis % w.ndim]
        w_min = w.amin(dim=dims, keepdim=True)
        w_max = w.amax(dim=dims, keepdim=True)
    else:
        w_min, w_max = w.amin(), w.amax()
    scale = torch.clamp_min((w_max - w_min) * _inv_levels(num_bits), 1e-10)
    r = torch.round((w - w_min) / scale)
    return torch.addcmul(w_min.double(), r.double(), scale.double()).to(w.dtype)


def fake_quantize_ste(w: torch.Tensor, **kw) -> torch.Tensor:
    """fake_quantize with the identity (straight-through) gradient."""
    return _STE.apply(w, fake_quantize(w.detach(), **kw))


def fake_quantize_act(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Per-tensor activation fake-quant with the straight-through gradient:
    the range always holds 0.0, and the zero point is an integer so that 0.0
    maps to an exact code (TFLite's affine int8)."""
    qmax = float((1 << num_bits) - 1)
    with torch.no_grad():
        xd = x.detach()
        x_min = torch.clamp_max(xd.amin(), 0.0)
        x_max = torch.clamp_min(xd.amax(), 0.0)
        scale = torch.clamp_min((x_max - x_min) * _inv_levels(num_bits), 1e-10)
        zp = torch.round(-x_min / scale)
        q = torch.clamp(torch.round(xd / scale) + zp, 0.0, qmax)
        xq = (q - zp) * scale
    return _STE.apply(x, xq)


class activation_fake_quant:
    """Context manager arming the activation fake-quant hook: inside it,
    every hookable relu6 of the model (models/blocks.py::ACT_FQ; the
    frontend opts out) runs fake_quantize_act on its output."""

    def __init__(self, num_bits: int = 8):
        self.num_bits = num_bits
        self._token = None

    def __enter__(self):
        self._token = blocks.ACT_FQ.set(
            lambda y: fake_quantize_act(y, num_bits=self.num_bits))
        return self

    def __exit__(self, *exc):
        blocks.ACT_FQ.reset(self._token)
        return False


def is_quantizable(name: str, tensor: torch.Tensor) -> bool:
    """The QAT weight selection (JAX is_quantizable over the port's
    names): convolution and dense weights only, not biases, BN, anything
    under audio_frontend or the attention-pooling score."""
    parts = name.split(".")
    if parts[0] in ("audio_frontend", "attn_pool_score"):
        return False
    return parts[-1] == "weight" and tensor.ndim >= 2


def quantize_params(params: dict[str, torch.Tensor], num_bits: int = 8,
                    per_channel: bool = True, ste: bool = True) -> dict[str, torch.Tensor]:
    """A copy of `params` with every quantizable weight fake-quantized over
    its output channels (axis 0); ste=True keeps the straight-through
    gradient to the float weight."""
    fq = fake_quantize_ste if ste else fake_quantize
    return {k: fq(v, num_bits=num_bits, per_channel=per_channel, channel_axis=0)
            if is_quantizable(k, v) else v for k, v in params.items()}
