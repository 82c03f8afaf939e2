"""In-memory TFLite graph fixtures for the INT8 executors (no JAX import).

The flagship graph (artifacts/flagship/bundle/model_quantized.tflite)
starts QUANTIZE [1, F, W, 1] -> STRIDED_SLICE (shrink axis 3) ->
TRANSPOSE (0, 2, 1) -> FULLY_CONNECTED, so no executor can fold its entry
quantize into the frontend. `entry_transpose_fixture` rewrites ops 1-2 into
the reference checkpoint's entry pattern, TRANSPOSE (0, 3, 2, 1) ->
RESHAPE [-1, W, F], which computes the same function: the codes reach the
FULLY_CONNECTED in the same [1, W, F] order.

The helpers work on either package's TFLiteGraph / TensorInfo / OpInfo
(birdnet_stm32_tpu.quant.tflite_import or birdnet_stm32_tpu_torch.quant.
tflite_import): they build new objects of the classes they are given.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

import numpy as np

FLAGSHIP_TFLITE = (Path(__file__).resolve().parents[1]
                   / "artifacts/flagship/bundle/model_quantized.tflite")


def _append(graph, proto, shape, dtype, data=None, scale=None, zero_point=None) -> int:
    idx = len(graph.tensors)
    graph.tensors.append(dataclasses.replace(
        proto, index=idx, shape=tuple(shape), dtype=dtype, scale=scale,
        zero_point=zero_point, quantized_dimension=0, data=data))
    return idx


def entry_transpose_fixture(graph):
    """A copy of the flagship graph whose ops 1-2 are TRANSPOSE (0, 3, 2, 1)
    to int8 [1, 1, W, F] and RESHAPE [-1, W, F] (the input graph is not
    modified)."""
    q, sl, tr = graph.ops[:3]
    if (q.name, sl.name, tr.name) != ("QUANTIZE", "STRIDED_SLICE", "TRANSPOSE"):
        raise ValueError(f"not the flagship entry: {q.name}, {sl.name}, {tr.name}")
    g = copy.copy(graph)
    g.tensors = list(graph.tensors)
    g.ops = list(graph.ops)
    qt = graph.tensors[q.outputs[0]]  # int8 [1, F, W, 1]
    _, F, W, _ = qt.shape
    perm = _append(g, qt, (4,), "int32", data=np.array([0, 3, 2, 1], np.int32))
    mid = _append(g, qt, (1, 1, W, F), "int8", scale=qt.scale.copy(),
                  zero_point=qt.zero_point.copy())
    shape = _append(g, qt, (3,), "int32", data=np.array([-1, W, F], np.int32))
    op_cls = type(q)
    g.ops[1] = op_cls("TRANSPOSE", [q.outputs[0], perm], [mid], {})
    g.ops[2] = op_cls("RESHAPE", [mid, shape], list(tr.outputs), {"new_shape": [-1, W, F]})
    return g


def flagship_features(B: int, seed: int = 0) -> np.ndarray:
    """The golden's inputs: uniform [0, 1) graph-input features [B, 257, 256, 1]."""
    return np.random.default_rng(seed).uniform(0, 1, (B, 257, 256, 1)).astype(np.float32)


def tie_features(B: int, scale: float, seed: int = 2) -> np.ndarray:
    """Features on and one float32 ulp either side of the entry QUANTIZE's
    rounding ties, float32((k + 0.5) * scale) for codes k in [0, 255)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 255, (B, 257, 256, 1))
    x = ((k + 0.5) * scale).astype(np.float32)
    step = rng.integers(-1, 2, x.shape)
    x = np.where(step > 0, np.nextafter(x, np.float32(2)),
                 np.where(step < 0, np.nextafter(x, np.float32(-1)), x))
    return x.astype(np.float32)


def tiny_conv_graph(module, padding: str, stride: tuple, dilation: tuple, act: int):
    """A small int8 graph with the convolution paths the flagship lacks,
    built for `module` (either package's quant.tflite_import): float
    [1, 9, 7, 3] -> QUANTIZE -> CONV_2D 3x3, 3 -> 4 channels (`padding`,
    `stride`, `dilation`, fused activation `act`, per-channel scales) ->
    DEPTHWISE_CONV_2D 3x3, depth_multiplier 2 (SAME, `dilation`, RELU6) ->
    CONV_2D 1x1 stride 2, 8 -> 5 -> DEQUANTIZE. Weights from a fixed seed."""
    rng = np.random.default_rng(3)
    tensors = []

    def add(shape, dtype, scale=None, zp=None, data=None, qdim=0):
        tensors.append(module.TensorInfo(
            len(tensors), tuple(shape), dtype,
            None if scale is None else np.asarray(scale, np.float64),
            None if zp is None else np.asarray(zp, np.int64), qdim, data))
        return len(tensors) - 1

    def out_size(n, k, s, d, pad):
        return -(-n // s) if pad == "SAME" else (n - (k - 1) * d - 1) // s + 1

    def weights(shape, lo, hi, qdim):
        n = shape[qdim]
        return add(shape, "int8", rng.uniform(lo, hi, n), np.zeros(n),
                   rng.integers(-127, 128, shape).astype(np.int8), qdim)

    def bias(n):
        return add((n,), "int32", data=rng.integers(-3000, 3000, n).astype(np.int32))

    H = out_size(9, 3, stride[0], dilation[0], padding)
    W = out_size(7, 3, stride[1], dilation[1], padding)
    x = add((1, 9, 7, 3), "float32")
    q = add((1, 9, 7, 3), "int8", [2.0 / 255], [-3])
    w1, b1 = weights((4, 3, 3, 3), 0.005, 0.015, 0), bias(4)
    c1 = add((1, H, W, 4), "int8", [0.05], [5])
    w2, b2 = weights((1, 3, 3, 8), 0.002, 0.006, 3), bias(8)
    c2 = add((1, H, W, 8), "int8", [0.08], [-10])
    w3, b3 = weights((5, 1, 1, 8), 0.002, 0.005, 0), bias(5)
    c3 = add((1, -(-H // 2), -(-W // 2), 5), "int8", [0.1], [0])
    out = add((1, -(-H // 2), -(-W // 2), 5), "float32")
    conv = dict(padding=padding, dilation=tuple(dilation))
    ops = [
        module.OpInfo("QUANTIZE", [x], [q], {}),
        module.OpInfo("CONV_2D", [q, w1, b1], [c1],
                      dict(conv, strides=tuple(stride), activation=act)),
        module.OpInfo("DEPTHWISE_CONV_2D", [c1, w2, b2], [c2],
                      dict(conv, padding="SAME", strides=(1, 1), activation=3,
                           depth_multiplier=2)),
        module.OpInfo("CONV_2D", [c2, w3, b3], [c3],
                      dict(padding="SAME", dilation=(1, 1), strides=(2, 2), activation=0)),
        module.OpInfo("DEQUANTIZE", [c3], [out], {}),
    ]
    graph = object.__new__(module.TFLiteGraph)
    graph.tensors, graph.ops, graph.inputs, graph.outputs = tensors, ops, [x], [out]
    return graph
