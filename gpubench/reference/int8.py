"""The benchmark's plain INT8 reference: an integer TFLite graph run op by
op in numpy on the CPU, each op as TFLite's int8 kernels define
it. It knows only the op kinds of the flagship graph and raises on any
other.

- Requantization is TFLite's MultiplyByQuantizedMultiplier in its two
  steps: SaturatingRoundingDoublingHighMul (nudge, then divide by 2^31
  truncating toward zero), then the rounding right shift, which rounds a
  tie up (toward +inf) as the interpreter's optimized kernels do (ruy's
  and NEON's rounding shift; the reference kernels' RoundingDivideByPOT
  rounds a negative tie down, one code apart). The multipliers come from
  QuantizeMultiplier on the float64 product of the float32 scales.
- CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED accumulate the offset
  codes (code - input zero point) times the weights, one kernel tap at a
  time, over the input padded with its zero point (so a pad tap adds 0).
  The products are summed as float64, which holds every integer below
  2^53 exactly: here |sum| < 257 * 255 * 127 < 2^24.
- ADD rescales both operands to twice the larger scale at 20 fractional
  bits; MUL requantizes the product of the offset codes; MEAN requantizes
  the sum of the offset codes by input scale / output scale with the count
  folded into the multiplier; REDUCE_MAX takes the largest code.
- DIV is the real quotient of the two dequantized operands in float64,
  rounded half away from zero to the output's grid.
- QUANTIZE multiplies by the float32 reciprocal of the scale and rounds
  half to even, as the interpreter's vectorised QUANTIZE does; DEQUANTIZE
  multiplies by the scale; LOGISTIC is TFLite's 256-entry table, populated
  in float32.

The interpreter's scores on the committed golden
(tests/goldens/torch_int8_flagship_scores.npz) are this module's, code for
code (gpubench/tests/test_gpubench_reference.py).

The graph is the raw .tflite file as tflite_file.py reads it; the batch-1
export's leading dimension stands for the batch.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from gpubench.reference import tflite_file
from gpubench.reference.tflite_file import Graph, Op

ROW_BLOCK = 16
ACT_NONE, ACT_RELU, ACT_RELU6 = 0, 1, 3


def load(path: Path) -> Graph:
    return tflite_file.read(Path(path).read_bytes())


def round_half_away(x):
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def quantize_multiplier(m: float) -> tuple[int, int]:
    """TFLite QuantizeMultiplier: m = q_fixed * 2^(shift - 31)."""
    if m == 0.0:
        return 0, 0
    q, shift = math.frexp(m)
    q_fixed = int(math.floor(q * 2.0 ** 31 + 0.5))
    if q_fixed == 1 << 31:
        q_fixed //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    return q_fixed, shift


def _multipliers(reals) -> tuple[np.ndarray, np.ndarray]:
    pairs = [quantize_multiplier(float(m)) for m in np.atleast_1d(reals)]
    return (np.array([q for q, _ in pairs], np.int64), np.array([s for _, s in pairs], np.int64))


def multiply_by_quantized_multiplier(x, qm, shift) -> np.ndarray:
    """TFLite MultiplyByQuantizedMultiplier of int64 values; qm and shift
    are scalars or per-channel vectors along the last axis."""
    x = np.asarray(x, np.int64)
    qm, shift = np.asarray(qm, np.int64), np.asarray(shift, np.int64)
    left, right = np.maximum(shift, 0), np.maximum(-shift, 0)
    a = x << left if left.any() else x
    assert np.abs(a).max(initial=0) < 2 ** 31, "MultiplyByQuantizedMultiplier: input over int32"
    # SaturatingRoundingDoublingHighMul: (ab + nudge) / 2^31 truncated, the
    # nudge 2^30 for ab >= 0 and 1 - 2^30 below; for every integer ab that
    # is floor((ab + 2^30) / 2^31), an arithmetic shift.
    high = (a * qm + (1 << 30)) >> 31
    half = np.where(right > 0, np.int64(1) << np.maximum(right - 1, 0), 0)
    return (high + half) >> right


def _sz(g: Graph, i: int) -> tuple[float, int]:
    t = g.tensors[i]
    return float(t.scale[0]), int(t.zero_point[0])


def _act_range(act: int, scale: float, zp: int) -> tuple[int, int]:
    """TFLite CalculateActivationRangeQuantized for int8."""
    def q(f):
        return zp + int(round_half_away(np.float32(f) / np.float32(scale)))
    if act == ACT_NONE:
        return -128, 127
    if act == ACT_RELU:
        return max(-128, q(0.0)), 127
    if act == ACT_RELU6:
        return max(-128, q(0.0)), min(127, q(6.0))
    raise NotImplementedError(f"fused activation {act}")


def _requant(acc, reals, zo: int, lo: int, hi: int) -> np.ndarray:
    qm, shift = _multipliers(reals)
    if qm.size == 1:
        qm, shift = qm[0], shift[0]
    return np.clip(multiply_by_quantized_multiplier(acc, qm, shift) + zo, lo, hi).astype(np.int8)


def _const(g: Graph, i: int) -> np.ndarray:
    data = g.tensors[i].data
    if data is None:
        raise NotImplementedError(f"tensor {i} has to be a constant")
    return data


def _bias(g: Graph, op: Op, n: int) -> np.ndarray:
    if len(op.inputs) > 2 and op.inputs[2] >= 0:
        return _const(g, op.inputs[2]).astype(np.int64)
    return np.zeros(n, np.int64)


def _same_pads(size: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    """TFLite's SAME padding: (before, after), the odd one after."""
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + (k - 1) * dilation + 1 - size)
    return total // 2, total - total // 2


def _padded_offsets(x: np.ndarray, zi: int, k, stride, dilation, same: bool) -> np.ndarray:
    """(x - zi) as float64, padded with 0 (a pad tap holds the zero point)."""
    xf = x.astype(np.float64) - zi
    if not same:
        return xf
    ph = _same_pads(x.shape[1], k[0], stride[0], dilation[0])
    pw = _same_pads(x.shape[2], k[1], stride[1], dilation[1])
    return np.pad(xf, ((0, 0), ph, pw, (0, 0)))


def _taps(xp: np.ndarray, k, stride, dilation):
    """((p, q), xp's window of tap (p, q)) for every kernel tap."""
    ho = (xp.shape[1] - (k[0] - 1) * dilation[0] - 1) // stride[0] + 1
    wo = (xp.shape[2] - (k[1] - 1) * dilation[1] - 1) // stride[1] + 1
    for p in range(k[0]):
        for q in range(k[1]):
            i0, j0 = p * dilation[0], q * dilation[1]
            yield (p, q), xp[:, i0:i0 + stride[0] * (ho - 1) + 1:stride[0],
                             j0:j0 + stride[1] * (wo - 1) + 1:stride[1], :]


def _conv(g: Graph, op: Op, v: dict) -> np.ndarray:
    x = v[op.inputs[0]]
    w = _const(g, op.inputs[1]).astype(np.float64)
    o = op.options
    si, zi = _sz(g, op.inputs[0])
    so, zo = _sz(g, op.outputs[0])
    depthwise = op.kind == "DEPTHWISE_CONV_2D"
    # CONV_2D weights [O, kh, kw, I]; DEPTHWISE_CONV_2D [1, kh, kw, C * m].
    k = w.shape[1:3]
    xp = _padded_offsets(x, zi, k, o["stride"], o["dilation"], o["same"])
    if depthwise:
        xp = np.repeat(xp, o["depth_multiplier"], axis=3)
    acc = 0.0
    for (p, q), tap in _taps(xp, k, o["stride"], o["dilation"]):
        acc = acc + (tap * w[0, p, q] if depthwise else tap @ w[:, p, q, :].T)
    n_out = w.shape[3] if depthwise else w.shape[0]
    acc = acc.astype(np.int64) + _bias(g, op, n_out)
    reals = np.float64(si) * g.tensors[op.inputs[1]].scale.astype(np.float64) / np.float64(so)
    return _requant(acc, reals, zo, *_act_range(o["activation"], so, zo))


def _fully_connected(g: Graph, op: Op, v: dict) -> np.ndarray:
    x, w = v[op.inputs[0]], _const(g, op.inputs[1])  # w [out, in]
    if op.options["weights_format"] != 0 or np.any(g.tensors[op.inputs[1]].zero_point != 0):
        raise NotImplementedError("FULLY_CONNECTED with shuffled or offset weights")
    if not op.options["keep_num_dims"]:
        x = x.reshape(-1, x.shape[-1])
    si, zi = _sz(g, op.inputs[0])
    so, zo = _sz(g, op.outputs[0])
    acc = ((x.astype(np.float64) - zi) @ w.T.astype(np.float64)).astype(np.int64)
    acc = acc + _bias(g, op, w.shape[0])
    reals = np.float64(si) * g.tensors[op.inputs[1]].scale.astype(np.float64) / np.float64(so)
    return _requant(acc, reals, zo, *_act_range(op.options["activation"], so, zo))


def _operand(g: Graph, v: dict, i: int) -> np.ndarray:
    t = g.tensors[i]
    return (v[i] if t.data is None else t.data).astype(np.int64)


def _add(g: Graph, op: Op, v: dict) -> np.ndarray:
    (a, b), out = op.inputs[:2], op.outputs[0]
    (sa, za), (sb, zb), (so, zo) = _sz(g, a), _sz(g, b), _sz(g, out)
    twice_max = 2.0 * max(sa, sb)
    ra = multiply_by_quantized_multiplier((_operand(g, v, a) - za) << 20,
                                          *quantize_multiplier(sa / twice_max))
    rb = multiply_by_quantized_multiplier((_operand(g, v, b) - zb) << 20,
                                          *quantize_multiplier(sb / twice_max))
    raw = multiply_by_quantized_multiplier(ra + rb, *quantize_multiplier(
        twice_max / ((1 << 20) * so)))
    lo, hi = _act_range(op.options["activation"], so, zo)
    return np.clip(raw + zo, lo, hi).astype(np.int8)


def _mul(g: Graph, op: Op, v: dict) -> np.ndarray:
    (a, b), out = op.inputs[:2], op.outputs[0]
    (sa, za), (sb, zb), (so, zo) = _sz(g, a), _sz(g, b), _sz(g, out)
    prod = (_operand(g, v, a) - za) * (_operand(g, v, b) - zb)
    raw = multiply_by_quantized_multiplier(prod, *quantize_multiplier(sa * sb / so))
    lo, hi = _act_range(op.options["activation"], so, zo)
    return np.clip(raw + zo, lo, hi).astype(np.int8)


def _div(g: Graph, op: Op, v: dict) -> np.ndarray:
    (a, b), out = op.inputs[:2], op.outputs[0]
    (sa, za), (sb, zb), (so, zo) = _sz(g, a), _sz(g, b), _sz(g, out)
    den = (_operand(g, v, b) - zb) * sb
    if np.any(den == 0):
        raise ZeroDivisionError("DIV by a zero operand")
    q = round_half_away((_operand(g, v, a) - za) * sa / den / so) + zo
    lo, hi = _act_range(op.options["activation"], so, zo)
    return np.clip(q, lo, hi).astype(np.int8)


def _axes(g: Graph, op: Op) -> tuple:
    return tuple(int(a) for a in np.atleast_1d(_const(g, op.inputs[1])))


def _reduce_max(g: Graph, op: Op, v: dict) -> np.ndarray:
    if _sz(g, op.inputs[0]) != _sz(g, op.outputs[0]):
        raise NotImplementedError("REDUCE_MAX that requantizes")
    return v[op.inputs[0]].max(axis=_axes(g, op), keepdims=op.options["keep_dims"])


def _mean(g: Graph, op: Op, v: dict) -> np.ndarray:
    x, axes = v[op.inputs[0]], _axes(g, op)
    si, zi = _sz(g, op.inputs[0])
    so, zo = _sz(g, op.outputs[0])
    n = math.prod(x.shape[a] for a in axes)
    qm, shift = quantize_multiplier(si / so)
    # The count folded into the multiplier, as TFLite's QuantizedMeanOrSum.
    fold = min(n.bit_length() - 1, 32, 31 + shift)
    qm, shift = (qm << fold) // n, shift - fold
    acc = (x.astype(np.int64) - zi).sum(axis=axes, keepdims=op.options["keep_dims"])
    return np.clip(multiply_by_quantized_multiplier(acc, qm, shift) + zo, -128, 127
                   ).astype(np.int8)


def _logistic(g: Graph, op: Op, v: dict) -> np.ndarray:
    si, zi = _sz(g, op.inputs[0])
    so, zo = _sz(g, op.outputs[0])
    f32 = np.float32
    codes = np.arange(-128, 128)
    x = f32(si) * (codes - zi).astype(f32)
    t = f32(1) / (f32(1) + np.exp(-x))
    table = np.clip(round_half_away(t * (f32(1) / f32(so))).astype(np.int64) + zo, -128, 127)
    return table.astype(np.int8)[v[op.inputs[0]].astype(np.int64) + 128]


def _quantize(g: Graph, op: Op, v: dict) -> np.ndarray:
    x = v[op.inputs[0]]
    if g.tensors[op.inputs[0]].dtype != np.float32:
        raise NotImplementedError("QUANTIZE of an integer tensor")
    s, z = _sz(g, op.outputs[0])
    q = np.rint(x.astype(np.float32) * (np.float32(1) / np.float32(s))) + z
    return np.clip(q, -128, 127).astype(np.int8)


def _dequantize(g: Graph, op: Op, v: dict) -> np.ndarray:
    s, z = _sz(g, op.inputs[0])
    return (s * (v[op.inputs[0]].astype(np.float64) - z)).astype(np.float32)


def _strided_slice(g: Graph, op: Op, v: dict) -> np.ndarray:
    x, o = v[op.inputs[0]], op.options
    if o["ellipsis_mask"] or o["new_axis_mask"]:
        raise NotImplementedError("STRIDED_SLICE with ellipsis or new axes")
    begin, end, strides = (_const(g, i) for i in op.inputs[1:4])
    if not (o["begin_mask"] & o["end_mask"] & 1):
        raise NotImplementedError("STRIDED_SLICE that cuts the batch")
    index = []
    for d in range(len(begin)):
        if (o["shrink_axis_mask"] >> d) & 1:
            index.append(int(begin[d]))
        else:
            index.append(slice(None if (o["begin_mask"] >> d) & 1 else int(begin[d]),
                               None if (o["end_mask"] >> d) & 1 else int(end[d]),
                               int(strides[d])))
    return x[tuple(index)]


def _transpose(g: Graph, op: Op, v: dict) -> np.ndarray:
    perm = tuple(int(p) for p in _const(g, op.inputs[1]))
    if perm[0] != 0:
        raise NotImplementedError("TRANSPOSE that moves the batch")
    return np.ascontiguousarray(np.transpose(v[op.inputs[0]], perm))


def _reshape(g: Graph, op: Op, v: dict) -> np.ndarray:
    x = v[op.inputs[0]]
    shape = [int(d) for d in _const(g, op.inputs[1])]
    if shape[0] != 1:
        raise NotImplementedError("RESHAPE that moves the batch")
    return x.reshape([x.shape[0]] + shape[1:])


OPS = {"CONV_2D": _conv, "DEPTHWISE_CONV_2D": _conv, "FULLY_CONNECTED": _fully_connected,
       "ADD": _add, "MUL": _mul, "DIV": _div, "REDUCE_MAX": _reduce_max, "MEAN": _mean,
       "LOGISTIC": _logistic, "QUANTIZE": _quantize, "DEQUANTIZE": _dequantize,
       "STRIDED_SLICE": _strided_slice, "TRANSPOSE": _transpose, "RESHAPE": _reshape}


def _run_block(g: Graph, x: np.ndarray) -> np.ndarray:
    v = {g.inputs[0]: x}
    for op in g.ops:
        v[op.outputs[0]] = OPS[op.kind](g, op, v)
    return v[g.outputs[0]]


def run(g: Graph, x: np.ndarray, threads: int | None = None) -> np.ndarray:
    """The graph's output for a batch of inputs: blocks of ROW_BLOCK rows,
    each on a thread of its own (numpy lets go of the GIL in its loops)."""
    unknown = sorted({op.kind for op in g.ops} - set(OPS))
    if unknown:
        raise NotImplementedError(f"op kinds {unknown}")
    blocks = [x[r:r + ROW_BLOCK] for r in range(0, x.shape[0], ROW_BLOCK)]
    workers = min(len(blocks), threads or os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        return np.concatenate(list(pool.map(lambda b: _run_block(g, b), blocks)))
