"""Tiny int8 graphs, one per executor op kind beyond the flagship's (no JAX).

`op_graph(module, kind)` builds the graph for either package's
quant.tflite_import (birdnet_stm32_tpu or birdnet_stm32_tpu_torch), as
tests/int8_fixture.py does: float input [1, 6, 5, 4] -> QUANTIZE -> the ops
under test -> DEQUANTIZE, weights and constants from a fixed seed. The
port's CPU tests hold each against the jitted JAX executor; the card test
holds the CUDA executor against the CPU one.
"""

from __future__ import annotations

import numpy as np

SHAPE = (1, 6, 5, 4)  # N, H, W, C of every graph's float input
KINDS = ("sub", "sum", "concatenation", "pad", "padv2", "softmax", "log",
         "maximum_minimum", "shape_pack_fill", "strided_slice", "depthwise_1x1",
         "transpose_elision")


class _Builder:
    def __init__(self, module, seed: int):
        self.m = module
        self.rng = np.random.default_rng(seed)
        self.tensors, self.ops = [], []

    def t(self, shape, dtype="int8", scale=None, zp=None, data=None, qdim=0):
        self.tensors.append(self.m.TensorInfo(
            len(self.tensors), tuple(shape), dtype,
            None if scale is None else np.asarray(np.atleast_1d(scale), np.float64),
            None if zp is None else np.asarray(np.atleast_1d(zp), np.int64), qdim, data))
        return len(self.tensors) - 1

    def const(self, values, dtype="int32", **quant):
        values = np.asarray(values, {"int32": np.int32, "int8": np.int8}[dtype])
        return self.t(values.shape, dtype, data=values, **quant)

    def op(self, name, inputs, outputs, **options):
        self.ops.append(self.m.OpInfo(name, list(inputs), list(outputs), options))

    def graph(self, x, out):
        g = object.__new__(self.m.TFLiteGraph)
        g.tensors, g.ops, g.inputs, g.outputs = self.tensors, self.ops, [x], [out]
        return g

    def entry(self, scale=2.0 / 255, zp=-3):
        x = self.t(SHAPE, "float32")
        q = self.t(SHAPE, scale=scale, zp=zp)
        self.op("QUANTIZE", [x], [q])
        return x, q

    def exit(self, t):
        out = self.t(self.tensors[t].shape, "float32")
        self.op("DEQUANTIZE", [t], [out])
        return out


def op_graph(module, kind: str):
    """The tiny graph for `kind` (one of KINDS), built for `module`."""
    b = _Builder(module, seed=KINDS.index(kind))
    x, q = b.entry()
    n, h, w, c = SHAPE
    if kind == "sub":
        # Two dynamic operands quantized differently, then a constant one.
        q2 = b.t(SHAPE, scale=3.0 / 255, zp=10)
        b.op("QUANTIZE", [x], [q2])
        d = b.t(SHAPE, scale=0.02, zp=4)
        b.op("SUB", [q, q2], [d], activation=0)
        k = b.const(b.rng.integers(-128, 128, (c,)), "int8", scale=0.01, zp=-7)
        y = b.t(SHAPE, scale=0.015, zp=-20)
        b.op("SUB", [d, k], [y], activation=1)
    elif kind == "sum":
        axes = b.const([1, 2])
        y = b.t((n, c), scale=0.3, zp=2)
        b.op("SUM", [q, axes], [y], keepdims=False)
    elif kind == "concatenation":
        q2 = b.t(SHAPE, scale=5.0 / 255, zp=-40)
        b.op("QUANTIZE", [x], [q2])
        y = b.t((n, h, w, 2 * c), scale=2.5 / 255, zp=-3)
        b.op("CONCATENATION", [q, q2], [y], axis=3, activation=1)
    elif kind in ("pad", "padv2"):
        pads = b.const([[0, 0], [1, 2], [0, 1], [2, 0]])
        y = b.t((n, h + 3, w + 1, c + 2), scale=2.0 / 255, zp=-3)
        if kind == "pad":
            b.op("PAD", [q, pads], [y])
        else:
            b.op("PADV2", [q, pads, b.const([17], "int8", scale=2.0 / 255, zp=-3)], [y])
    elif kind == "softmax":
        y = b.t(SHAPE, scale=1.0 / 256, zp=-128)
        b.op("SOFTMAX", [q], [y], beta=1.0)
    elif kind == "log":
        # The db magnitude scaling's pattern: MAXIMUM(x, eps) -> LOG.
        eps = b.const([-2], "int8", scale=2.0 / 255, zp=-3)
        m = b.t(SHAPE, scale=2.0 / 255, zp=-3)
        b.op("MAXIMUM", [q, eps], [m])
        y = b.t(SHAPE, scale=0.05, zp=60)
        b.op("LOG", [m], [y])
    elif kind == "maximum_minimum":
        # Differently quantized operands (the float-faithful path), then
        # one quantization throughout (the raw-code compare).
        q2 = b.t(SHAPE, scale=3.0 / 255, zp=9)
        b.op("QUANTIZE", [x], [q2])
        m = b.t(SHAPE, scale=2.0 / 255, zp=-3)
        b.op("MAXIMUM", [q2, q], [m])
        k = b.const(b.rng.integers(-60, 60, SHAPE), "int8", scale=2.0 / 255, zp=-3)
        y = b.t(SHAPE, scale=2.0 / 255, zp=-3)
        b.op("MINIMUM", [m, k], [y])
    elif kind == "shape_pack_fill":
        # The Keras hybrid frontend's channel pad: SHAPE -> slices -> PACK ->
        # FILL of a constant code -> CONCATENATION -> 1x1 CONV_2D (folded).
        shp = b.t((4,), "int32")
        b.op("SHAPE", [q], [shp])
        dims = []
        for d in range(3):
            s = b.t((), "int32")
            b.op("STRIDED_SLICE", [shp, b.const([d]), b.const([d + 1]), b.const([1])], [s],
                 begin_mask=0, end_mask=0, ellipsis_mask=0, new_axis_mask=0,
                 shrink_axis_mask=1)
            dims.append(s)
        packed = b.t((4,), "int32")
        b.op("PACK", [*dims, b.const(4)], [packed], axis=0, count=4)
        fill = b.t((n, h, w, 4), scale=2.0 / 255, zp=-3)
        b.op("FILL", [packed, b.const(-3, "int8")], [fill])
        cat = b.t((n, h, w, c + 4), scale=2.0 / 255, zp=-3)
        b.op("CONCATENATION", [q, fill], [cat], axis=3, activation=0)
        y = _conv(b, cat, c + 4, 6, 1)
    elif kind == "strided_slice":
        # Strides, a negative stride, begin / end masks and a shrink.
        begin, end = b.const([0, 1, w - 1, 0]), b.const([1, h, 0, 3])
        y = b.t((n, -(-(h - 1) // 2), w - 1, 3), scale=2.0 / 255, zp=-3)
        b.op("STRIDED_SLICE", [q, begin, end, b.const([1, 2, -1, 1])], [y],
             begin_mask=1, end_mask=1, ellipsis_mask=0, new_axis_mask=0,
             shrink_axis_mask=0)
        z = b.t((n, -(-(h - 1) // 2), 3), scale=2.0 / 255, zp=-3)
        b.op("STRIDED_SLICE", [y, b.const([0, 0, 1, 0]), b.const([1, 0, 2, 3]),
                               b.const([1, 1, 1, 1])], [z],
             begin_mask=3, end_mask=11, ellipsis_mask=0, new_axis_mask=0,
             shrink_axis_mask=4)
        y = z
    elif kind == "depthwise_1x1":
        wt = b.t((1, 1, 1, c), scale=b.rng.uniform(0.002, 0.01, c), zp=np.zeros(c), qdim=3,
                 data=b.rng.integers(-127, 128, (1, 1, 1, c)).astype(np.int8))
        bias = b.const(b.rng.integers(-3000, 3000, c))
        y = b.t(SHAPE, scale=0.01, zp=5)
        b.op("DEPTHWISE_CONV_2D", [q, wt, bias], [y], padding="SAME", strides=(1, 1),
             dilation=(1, 1), activation=3, depth_multiplier=1)
    elif kind == "transpose_elision":
        # TRANSPOSE (0, 2, 1, 3) -> identity STRIDED_SLICE -> 3x3 CONV_2D.
        t = b.t((n, w, h, c), scale=2.0 / 255, zp=-3)
        b.op("TRANSPOSE", [q, b.const([0, 2, 1, 3])], [t])
        s = b.t((n, w, h, c), scale=2.0 / 255, zp=-3)
        b.op("STRIDED_SLICE", [t, b.const([0, 0, 0, 0]), b.const([0, 0, 0, 0]),
                               b.const([1, 1, 1, 1])], [s],
             begin_mask=15, end_mask=15, ellipsis_mask=0, new_axis_mask=0,
             shrink_axis_mask=0)
        y = _conv(b, s, c, 5, 3)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return b.graph(x, b.exit(y))


def _conv(b: _Builder, src: int, cin: int, cout: int, k: int) -> int:
    """A k x k SAME CONV_2D, cin -> cout, per-channel weights; its output."""
    n, h, w, _ = b.tensors[src].shape
    wt = b.t((cout, k, k, cin), scale=b.rng.uniform(0.002, 0.01, cout), zp=np.zeros(cout),
             data=b.rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8))
    bias = b.const(b.rng.integers(-3000, 3000, cout))
    y = b.t((n, h, w, cout), scale=0.05, zp=2)
    b.op("CONV_2D", [src, wt, bias], [y], padding="SAME", strides=(1, 1), dilation=(1, 1),
         activation=0)
    return y


def op_inputs(batch: int, seed: int = 0) -> np.ndarray:
    """Float inputs [batch, 6, 5, 4] spanning the entry quantizer's range."""
    return np.random.default_rng(seed).uniform(-0.3, 1.0, (batch, *SHAPE[1:])).astype(np.float32)
