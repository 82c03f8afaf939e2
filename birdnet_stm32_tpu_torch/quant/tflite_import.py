"""TFLite flatbuffer -> PyTorch integer-graph executor (port of
birdnet_stm32_tpu/quant/tflite_import.py).

The reference deploys an INT8 TFLite graph and validates it with the TFLite
interpreter. This module parses the .tflite flatbuffer with the port's own
reader (quant/tflite_schema.py) and builds an executor that runs the same
integer graph with torch tensors on one device, bit-equal to the JAX
package's jitted executor:

- integer accumulations are exact: the GEMM-shaped ops (1x1 CONV_2D,
  FULLY_CONNECTED, any other CONV_2D through `unfold`) multiply the int8
  codes as float32 with TF32 off, after a host check per op that every
  partial sum stays below 2^24 (sum |w| * 255 < 2^24), and as float64
  otherwise; depthwise convolutions and convolutions over one input channel
  are shifted int32 multiply-adds over the zero-point-padded input. No cuDNN
  convolution: its Winograd and FFT algorithms are not exact on integers;
- requantization is TFLite's MultiplyByQuantizedMultiplier in int64,
  ((x << left) * qm + K) >> (31 + right) with K = 2^30 + 2^(30 + right)
  (2^30 alone when right = 0), for every channel. The JAX package splits
  this product into 16-bit limbs because the TPU has no int64, and rewrites
  provably constant channels; both are bit-equal to the direct form;
- float steps (the entry QUANTIZE, DIV, DEQUANTIZE) repeat the jitted JAX
  float32 arithmetic. XLA turns a division by a constant into a multiply by
  its float32 reciprocal, so these multiply by an explicit float32
  reciprocal tensor; never divide a CUDA tensor by a Python scalar, which
  ATen also turns into a reciprocal multiply, computed differently;
- LOGISTIC is a 256-entry lookup table built on the host in float64.

The executor runs the 14 op kinds of the flagship graph: QUANTIZE,
DEQUANTIZE, TRANSPOSE, STRIDED_SLICE, RESHAPE, CONV_2D, DEPTHWISE_CONV_2D,
FULLY_CONNECTED, ADD, MUL, DIV, REDUCE_MAX, MEAN and LOGISTIC. Any other op,
requant="fast", and the JAX package's layout pre-passes (transpose elision,
constant-pad CONCAT folding, which change no value) are not ported yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.quant import tflite_schema as fb

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1: the remaining INT8 executor ops)"

# FusedActivationFunction enum.
_ACT_NONE, _ACT_RELU, _ACT_RELU_N1_1, _ACT_RELU6 = 0, 1, 2, 3


@dataclass
class TensorInfo:
    index: int
    shape: tuple
    dtype: str
    scale: np.ndarray | None  # [1] per-tensor or [C] per-channel, float64
    zero_point: np.ndarray | None  # int64
    quantized_dimension: int
    data: np.ndarray | None  # constant buffer contents, else None


@dataclass
class OpInfo:
    name: str
    inputs: list[int]
    outputs: list[int]
    options: dict[str, Any] = field(default_factory=dict)


_DTYPES = {
    fb.FLOAT32: ("float32", np.float32),
    fb.INT8: ("int8", np.int8),
    fb.INT16: ("int16", np.int16),
    fb.INT32: ("int32", np.int32),
    fb.INT64: ("int64", np.int64),
    fb.BOOL: ("bool", np.bool_),
    fb.UINT8: ("uint8", np.uint8),
}


class TFLiteGraph:
    """Parsed .tflite model: tensor metadata + ops in execution order."""

    def __init__(self, path_or_bytes: str | Path | bytes):
        if isinstance(path_or_bytes, bytes):
            buf = path_or_bytes
        else:
            buf = Path(path_or_bytes).read_bytes()
        model = fb.read_model(buf)

        self.tensors: list[TensorInfo] = []
        for i, t in enumerate(model.tensors):
            dtype_name, np_dtype = _DTYPES[t.type]
            q = t.quantization
            scale = zp = None
            qdim = 0
            if q is not None and q.scale is not None and q.scale.size > 0:
                scale = q.scale.astype(np.float64)
                zp = (np.zeros_like(scale, np.int64) if q.zero_point is None
                      else q.zero_point.astype(np.int64))
                qdim = q.quantized_dimension
            shape = () if t.shape is None else tuple(int(s) for s in t.shape)
            raw = model.buffers[t.buffer]
            data = None
            if raw is not None and raw.size > 0:
                data = np.frombuffer(raw.tobytes(), dtype=np_dtype).reshape(shape)
            self.tensors.append(TensorInfo(i, shape, dtype_name, scale, zp, qdim, data))

        self.ops: list[OpInfo] = []
        for op in model.operators:
            code = op.builtin_code
            name = (fb.BUILTIN_OPERATORS[code] if 0 <= code < len(fb.BUILTIN_OPERATORS)
                    else f"BUILTIN_{code}")
            self.ops.append(OpInfo(name, [int(x) for x in op.inputs],
                                   [int(x) for x in op.outputs],
                                   fb.builtin_options(name, op.options)))
        self.inputs = [int(x) for x in model.inputs]
        self.outputs = [int(x) for x in model.outputs]

        # The executor implements int8 arithmetic ([-128, 127] clamps, int8
        # casts) throughout. uint8 (pre-TF-2.3 writers) and int16-activation
        # graphs would parse but compute garbage: reject them loudly.
        used = {i for op in self.ops for i in (*op.inputs, *op.outputs) if i >= 0}
        bad = sorted({self.tensors[i].dtype for i in used
                      if self.tensors[i].dtype in ("uint8", "int16")})
        if bad:
            raise NotImplementedError(
                f"graph uses {bad} tensors: this executor implements the "
                "int8 quantization scheme only (uint8/int16 graphs would be "
                "silently corrupted, not approximated)")


# --- Requantization arithmetic ----------------------------------------------


def _round_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (TFLite quantize rounding)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _quantize_multiplier(m: float) -> tuple[int, int]:
    """double multiplier -> (int32 fixed-point multiplier, shift)."""
    if m == 0.0:
        return 0, 0
    q, shift = math.frexp(m)
    # TfLiteRound rounds half away from zero; q > 0 here (quant scales are
    # positive), so floor(x + 0.5) is half-away.
    q_fixed = int(math.floor(q * (1 << 31) + 0.5))
    if q_fixed == (1 << 31):
        q_fixed //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    return q_fixed, shift


def _mbqm_host(x: np.ndarray, qm: int, shift: int) -> np.ndarray:
    """MultiplyByQuantizedMultiplier on the host in int64 (|x << left| < 2^31,
    so x * qm < 2^62)."""
    x = np.asarray(x, np.int64)
    left, right = max(shift, 0), max(-shift, 0)
    K = (1 << 30) + ((1 << (30 + right)) if right > 0 else 0)
    return ((x << left) * qm + K) >> (31 + right)


def _channel_const(v: np.ndarray, device: torch.device) -> int | torch.Tensor:
    """A per-channel int64 constant: a Python int when every channel shares
    it, else a [C] tensor broadcast along the last axis."""
    v = np.atleast_1d(np.asarray(v, np.int64))
    if np.all(v == v[0]):
        return int(v[0])
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def _mbqm_fn(qm, shift, device: torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """Exact MultiplyByQuantizedMultiplier of an int64 tensor, per tensor
    (scalar qm/shift) or per channel ([C] vectors, last axis):
    ((x << left) * qm + K) >> (31 + right), as _mbqm_host."""
    qm = np.atleast_1d(np.asarray(qm, np.int64))
    shift = np.atleast_1d(np.asarray(shift, np.int64))
    left = np.maximum(shift, 0)
    right = np.maximum(-shift, 0)
    K = (np.int64(1) << 30) + np.where(right > 0, np.int64(1) << (30 + right), 0)
    has_left = bool(left.any())
    left_c, qm_c, K_c, rs_c = (_channel_const(v, device) for v in (left, qm, K, 31 + right))

    def mbqm(x: torch.Tensor) -> torch.Tensor:
        if has_left:
            x = torch.bitwise_left_shift(x, left_c)
        return torch.bitwise_right_shift(x * qm_c + K_c, rs_c)

    return mbqm


def _requant_fn(multipliers, zp: int, lo: int, hi: int, device: torch.device):
    """int64 accumulator [..., C] -> int8 codes: exact per-channel MBQM by
    each multiplier, + zp, clamped to the activation bounds."""
    qms = [_quantize_multiplier(float(m)) for m in np.atleast_1d(multipliers)]
    mbqm = _mbqm_fn([q for q, _ in qms], [s for _, s in qms], device)
    return lambda acc: torch.clamp(mbqm(acc) + zp, lo, hi).to(torch.int8)


def _act_bounds(activation: int, scale: float, zp: int) -> tuple[int, int]:
    """Fused-activation clamp bounds in the quantized domain."""
    lo, hi = -128, 127
    if activation == _ACT_RELU:
        lo = max(lo, int(zp))
    elif activation == _ACT_RELU6:
        lo = max(lo, int(zp))
        hi = min(hi, int(round(6.0 / scale) + zp))
    elif activation == _ACT_RELU_N1_1:
        lo = max(lo, int(round(-1.0 / scale) + zp))
        hi = min(hi, int(round(1.0 / scale) + zp))
    return lo, hi


def _tf_same_pads(in_size: int, k: int, stride: int, dilation: int = 1):
    eff_k = (k - 1) * dilation + 1
    out = -(-in_size // stride)
    total = max(0, (out - 1) * stride + eff_k - in_size)
    return total // 2, total - total // 2


def _f32_const(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def f32_reciprocal(scale: float, device: torch.device) -> torch.Tensor:
    """float32(1) / float32(scale) as a 0-dim tensor on `device`: what
    jitted XLA multiplies by where the JAX source divides by a constant."""
    return _f32_const(np.float32(1.0) / np.float32(scale), device)


def quantize_f32(x: torch.Tensor, inv_scale: torch.Tensor, zp: int) -> torch.Tensor:
    """float32 -> int8 codes: round_away(x * inv_scale) + zp, clipped; the
    executor's entry QUANTIZE and the frontend kernels' int8 epilogue."""
    q = _round_away(x * inv_scale) + zp
    return torch.clamp(q, -128, 127).to(torch.int8)


# --- Entry pattern -----------------------------------------------------------


def entry_transpose_perm(graph: TFLiteGraph) -> tuple | None:
    """Perm of the graph's leading QUANTIZE -> TRANSPOSE pattern, else None.

    A caller whose features come in the transposed orientation can feed
    them directly (build_executor(pretransposed_input=True)), or quantize
    them itself (prequantized_input=True), and ops {0, 1} are skipped.
    """
    if len(graph.ops) < 2:
        return None
    q, t = graph.ops[0], graph.ops[1]
    # The TRANSPOSE must be the quantize output's ONLY consumer: skipping
    # ops {0, 1} must not starve another op of the quantized tensor.
    n_cons = sum(q.outputs[0] in op.inputs for op in graph.ops)
    if (q.name == "QUANTIZE" and q.inputs[0] == graph.inputs[0]
            and t.name == "TRANSPOSE" and t.inputs[0] == q.outputs[0]
            and n_cons == 1 and q.outputs[0] not in graph.outputs
            and graph.tensors[t.inputs[1]].data is not None):
        return tuple(int(p) for p in graph.tensors[t.inputs[1]].data)
    return None


def entry_quant_params(graph: TFLiteGraph) -> tuple[float, int]:
    """(scale, zero_point) of the graph's entry QUANTIZE output: what a
    producer fusing the entry quantization (prequantized_input) must
    quantize the float features with."""
    if entry_transpose_perm(graph) is None:
        raise ValueError("graph does not start with QUANTIZE -> TRANSPOSE")
    t = graph.tensors[graph.ops[0].outputs[0]]
    return float(t.scale[0]), int(t.zero_point[0])


# --- Ops -----------------------------------------------------------------------
#
# Each _op_* function runs once per executor, on the host: it reads the op's
# constants, uploads what the op needs to the device and returns
# step(vals), which reads the op's inputs from `vals` (tensor index ->
# torch tensor) and stores its output there.

Step = Callable[[dict], None]


def _sz(graph: TFLiteGraph, idx: int) -> tuple[float, int]:
    t = graph.tensors[idx]
    return float(t.scale[0]), int(t.zero_point[0])


def _host_const(graph: TFLiteGraph, idx: int, what: str) -> np.ndarray:
    data = graph.tensors[idx].data
    if data is None:
        raise NotImplementedError(f"{what} from a computed tensor {idx}: {_NOT_PORTED}")
    return np.asarray(data)


def _gemm_dtype(w: np.ndarray, tap_axes: tuple) -> torch.dtype:
    """float32 when every partial sum of int8 codes times `w` is exact in it
    (sum |w| * 255 < 2^24 for every output channel), else float64."""
    bound = int(np.abs(w.astype(np.int64)).sum(axis=tap_axes).max()) * 255
    return torch.float32 if bound < (1 << 24) else torch.float64


def _op_quantize(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    s, z = _sz(graph, o)
    if graph.tensors[i].dtype == "float32":
        inv = f32_reciprocal(s, dev)

        def step(v):
            v[o] = quantize_f32(v[i], inv, z)
        return step
    # int8 -> int8: TFLite's Requantize, MBQM(x - zi, qm, shift) + zo.
    si, zi = _sz(graph, i)
    mbqm = _mbqm_fn(*_quantize_multiplier(si / s), dev)

    def step(v):
        q = mbqm(v[i].to(torch.int64) - zi) + z
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _op_dequantize(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    s, z = _sz(graph, i)
    s32 = _f32_const(s, dev)

    def step(v):
        v[o] = (v[i].to(torch.float32) - z) * s32
    return step


def _op_transpose(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    perm = tuple(int(p) for p in _host_const(graph, op.inputs[1], "TRANSPOSE perm"))

    def step(v):
        v[o] = v[i].permute(perm)
    return step


def _op_strided_slice(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    begin, end, strides = ([int(x) for x in _host_const(graph, k, "STRIDED_SLICE bounds")]
                           for k in op.inputs[1:4])
    opts = op.options
    if opts.get("new_axis_mask") or opts.get("ellipsis_mask"):
        raise NotImplementedError(
            "STRIDED_SLICE with new_axis/ellipsis masks is not supported")
    if any(s <= 0 for s in strides):
        raise NotImplementedError(f"STRIDED_SLICE with strides {strides}: {_NOT_PORTED}")
    bm, em, sm = opts["begin_mask"], opts["end_mask"], opts["shrink_axis_mask"]
    src_shape = graph.tensors[i].shape
    slices = []
    for d in range(len(begin)):
        b = None if (bm >> d) & 1 else begin[d]
        e = None if (em >> d) & 1 else end[d]
        if d == 0 and b in (None, 0) and e == 1 and src_shape and src_shape[0] == 1:
            # A literal batch-1 end from a batch-1 export means "the whole
            # batch": remap it to the executor's batch, as RESHAPE does.
            e = None
        slices.append(begin[d] if (sm >> d) & 1 else slice(b, e, strides[d]))
    slices = tuple(slices)

    def step(v):
        v[o] = v[i][slices]
    return step


def _op_reshape(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    if len(op.inputs) > 1 and op.inputs[1] >= 0:
        spec = [int(d) for d in _host_const(graph, op.inputs[1], "RESHAPE shape")]
    else:
        spec = [int(d) for d in op.options["new_shape"]]

    def step(v):
        src = v[i]
        new_shape = list(spec)
        # A spec exported at batch 1 may carry a literal leading 1: remap it
        # to -1, or to the real batch when the spec's -1 is elsewhere.
        if new_shape and new_shape[0] not in (-1, src.shape[0]):
            new_shape[0] = -1 if -1 not in new_shape[1:] else src.shape[0]
        v[o] = src.reshape(new_shape)
    return step


def _tap_conv(xp: torch.Tensor, w: torch.Tensor, out_hw, strides, dil) -> torch.Tensor:
    """int32 acc[b, i, j, c] = sum_{p, q} xp[b, i*sh + p*dh, j*sw + q*dw, c]
    * w[p, q, c]: one multiply-add per tap over the padded NHWC input (a
    single input channel broadcasts against [kh, kw, C_out] weights)."""
    (Ho, Wo), (sh, sw), (dh, dw) = out_hw, strides, dil
    acc = None
    for p in range(w.shape[0]):
        for q in range(w.shape[1]):
            tap = xp[:, p * dh: p * dh + sh * (Ho - 1) + 1: sh,
                     q * dw: q * dw + sw * (Wo - 1) + 1: sw, :]
            if acc is None:
                acc = tap * w[p, q]
            else:
                acc.addcmul_(tap, w[p, q])
    return acc


def _op_conv(graph, op, dev) -> Step:
    name, (i, wi), o = op.name, op.inputs[:2], op.outputs[0]
    w = _host_const(graph, wi, f"{name} weights")  # CONV [O,kh,kw,I]; DW [1,kh,kw,C]
    bias = (_host_const(graph, op.inputs[2], f"{name} bias").astype(np.int64)
            if len(op.inputs) > 2 and op.inputs[2] >= 0 else np.zeros(1, np.int64))
    si, zi = _sz(graph, i)
    sw = graph.tensors[wi].scale
    so, zo = _sz(graph, o)
    sh, swd = op.options["strides"]
    dil = tuple(op.options.get("dilation", (1, 1)))
    same = op.options["padding"] == "SAME"
    lo, hi = _act_bounds(op.options["activation"], so, zo)
    requant = _requant_fn(si * sw.astype(np.float64) / so, zo, lo, hi, dev)
    depthwise = name == "DEPTHWISE_CONV_2D"
    kh, kw = w.shape[1], w.shape[2]
    c_in = graph.tensors[i].shape[3]

    if depthwise and kh == kw == 1 and (sh, swd) == (1, 1) and dil == (1, 1) \
            and w.shape[0] == 1 and w.shape[3] == c_in:
        # 1x1 stride-1 depthwise conv == per-channel affine:
        # acc[..., c] = w_c * (x - zp) + bias_c (PWL/PCEN frontend encodings).
        wv = torch.as_tensor(w.reshape(-1).astype(np.int64), device=dev)
        bv = torch.as_tensor(np.broadcast_to(bias, w.shape[3:]).copy(), device=dev)

        def step(v):
            v[o] = requant((v[i].to(torch.int64) - zi) * wv + bv)
        return step

    tap_axes = (0, 1, 2) if depthwise else (1, 2, 3)
    w_sum = w.astype(np.int64).sum(axis=tap_axes)
    # The zero-point fold: padding with zi makes sum w * (x - zi) exact.
    correction = torch.as_tensor(bias - zi * w_sum, dtype=torch.int64, device=dev)

    def padded(x):
        if not same:
            return x
        ph = _tf_same_pads(x.shape[1], kh, sh, dil[0])
        pw = _tf_same_pads(x.shape[2], kw, swd, dil[1])
        return F.pad(x, (0, 0, *pw, *ph), value=zi) if any(ph + pw) else x

    def out_hw(xp):
        return ((xp.shape[1] - (kh - 1) * dil[0] - 1) // sh + 1,
                (xp.shape[2] - (kw - 1) * dil[1] - 1) // swd + 1)

    if depthwise or c_in == 1:
        # Shifted int32 multiply-adds; depth_multiplier m repeats each input
        # channel m times (output channel c reads input channel c // m).
        w_taps = (w[0] if depthwise else np.transpose(w[..., 0], (1, 2, 0)))
        w_taps = torch.as_tensor(w_taps.astype(np.int32), device=dev)  # [kh, kw, C_out]
        repeat = w.shape[3] // c_in if depthwise else 1

        def step(v):
            xp = padded(v[i]).to(torch.int32)
            if repeat > 1:
                xp = xp.repeat_interleave(repeat, dim=3)
            acc = _tap_conv(xp, w_taps, out_hw(xp), (sh, swd), dil)
            v[o] = requant(acc.to(torch.int64) + correction)
        return step

    gemm = _gemm_dtype(w, tap_axes)
    O = w.shape[0]
    if kh == kw == 1:
        wt = torch.as_tensor(w.reshape(O, -1).T.copy(), dtype=gemm, device=dev)  # [I, O]

        def step(v):
            x = v[i][:, ::sh, ::swd, :]
            acc = (x.to(gemm) @ wt).to(torch.int64)
            v[o] = requant(acc + correction)
        return step

    # Any other CONV_2D: unfold the zero-point-padded input into taps
    # (channel-major, as unfold orders them) and multiply.
    wt = torch.as_tensor(np.transpose(w, (3, 1, 2, 0)).reshape(-1, O).copy(),
                         dtype=gemm, device=dev)  # [I*kh*kw, O]

    def step(v):
        xp = padded(v[i])
        Ho, Wo = out_hw(xp)
        cols = F.unfold(xp.to(gemm).permute(0, 3, 1, 2), (kh, kw), dilation=dil,
                        stride=(sh, swd))  # [B, I*kh*kw, Ho*Wo]
        acc = (cols.transpose(1, 2) @ wt).to(torch.int64)
        v[o] = requant(acc.reshape(xp.shape[0], Ho, Wo, O) + correction)
    return step


def _op_fully_connected(graph, op, dev) -> Step:
    if op.options.get("weights_format", 0) != 0:
        raise NotImplementedError(
            "FULLY_CONNECTED with shuffled weights format "
            f"{op.options['weights_format']} is not supported")
    i, wi, o = op.inputs[0], op.inputs[1], op.outputs[0]
    w = _host_const(graph, wi, "FULLY_CONNECTED weights")  # [out, in]
    in_rank, out_rank = len(graph.tensors[i].shape), len(graph.tensors[o].shape)
    if in_rank > 2 and out_rank < in_rank:
        # TFLite flattens rank > 2 inputs to [prod(leading), in]; the
        # broadcast product below keeps the leading dims (KeepNumDims).
        raise NotImplementedError(
            f"FULLY_CONNECTED flattens rank-{in_rank} input to rank-{out_rank} "
            "output; that reshape is not replicated")
    bias = (_host_const(graph, op.inputs[2], "FULLY_CONNECTED bias").astype(np.int64)
            if len(op.inputs) > 2 and op.inputs[2] >= 0 else 0)
    si, zi = _sz(graph, i)
    sw = graph.tensors[wi].scale
    so, zo = _sz(graph, o)
    lo, hi = _act_bounds(op.options["activation"], so, zo)
    requant = _requant_fn(si * sw.astype(np.float64) / so, zo, lo, hi, dev)
    gemm = _gemm_dtype(w, (1,))
    wt = torch.as_tensor(w.T.copy(), dtype=gemm, device=dev)  # [in, out]
    correction = torch.as_tensor(bias - zi * w.astype(np.int64).sum(axis=1),
                                 dtype=torch.int64, device=dev)

    def step(v):
        acc = (v[i].to(gemm) @ wt).to(torch.int64)
        v[o] = requant(acc + correction)
    return step


def _op_add(graph, op, dev) -> Step:
    # TFLite int8 ADD: rescale both inputs to twice the larger input scale
    # at 20 fractional bits, add, requantize. A constant operand is rescaled
    # once, on the host.
    (a, b), o = op.inputs[:2], op.outputs[0]
    sa, za = _sz(graph, a)
    sb, zb = _sz(graph, b)
    so, zo = _sz(graph, o)
    left_shift = 20
    twice_max = 2.0 * max(sa, sb)

    def rescaled(idx, zp, scale):
        qm, shift = _quantize_multiplier(scale / twice_max)
        data = graph.tensors[idx].data
        if data is not None:
            r = _mbqm_host((np.asarray(data, np.int64) - zp) << left_shift, qm, shift)
            r = torch.as_tensor(r, dtype=torch.int64, device=dev)
            return lambda v: r
        mbqm = _mbqm_fn(qm, shift, dev)
        return lambda v: mbqm((v[idx].to(torch.int64) - zp) << left_shift)

    ra, rb = rescaled(a, za, sa), rescaled(b, zb, sb)
    out = _mbqm_fn(*_quantize_multiplier(twice_max / ((1 << left_shift) * so)), dev)
    lo, hi = _act_bounds(op.options["activation"], so, zo)

    def step(v):
        v[o] = torch.clamp(out(ra(v) + rb(v)) + zo, lo, hi).to(torch.int8)
    return step


def _op_mul(graph, op, dev) -> Step:
    # TFLite int8 MUL: the product of the offset codes, one MBQM.
    (a, b), o = op.inputs[:2], op.outputs[0]
    sa, za = _sz(graph, a)
    sb, zb = _sz(graph, b)
    so, zo = _sz(graph, o)

    def offset(idx, zp):
        data = graph.tensors[idx].data
        if data is not None:
            c = torch.as_tensor(np.asarray(data, np.int64) - zp, device=dev)
            return lambda v: c
        return lambda v: v[idx].to(torch.int64) - zp

    fa, fb_ = offset(a, za), offset(b, zb)
    mbqm = _mbqm_fn(*_quantize_multiplier(sa * sb / so), dev)
    lo, hi = _act_bounds(op.options["activation"], so, zo)

    def step(v):
        v[o] = torch.clamp(mbqm(fa(v) * fb_(v)) + zo, lo, hi).to(torch.int8)
    return step


def _op_div(graph, op, dev) -> Step:
    # Float-faithful, as the JAX package: dequantize both, divide, multiply
    # by the float32 reciprocal of the output scale, round half away.
    (a, b), o = op.inputs[:2], op.outputs[0]
    sa, za = _sz(graph, a)
    sb, zb = _sz(graph, b)
    so, zo = _sz(graph, o)
    sa32, sb32, inv_so = _f32_const(sa, dev), _f32_const(sb, dev), f32_reciprocal(so, dev)
    lo, hi = _act_bounds(op.options["activation"], so, zo)

    def step(v):
        fa = (v[a].to(torch.float32) - za) * sa32
        fb_ = (v[b].to(torch.float32) - zb) * sb32
        q = _round_away(fa / fb_ * inv_so) + zo
        v[o] = torch.clamp(q, lo, hi).to(torch.int8)
    return step


def _reduce_axes(graph, op) -> tuple:
    return tuple(int(x) for x in np.atleast_1d(_host_const(graph, op.inputs[1], "axes")))


def _op_reduce_max(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    axes, keep = _reduce_axes(graph, op), op.options.get("keepdims", True)
    si, zi = _sz(graph, i)
    so, zo = _sz(graph, o)
    if si == so and zi == zo:
        def step(v):
            v[o] = v[i].amax(dim=axes, keepdim=keep)
        return step
    ratio = _f32_const(si / so, dev)

    def step(v):
        m = v[i].amax(dim=axes, keepdim=keep)
        q = _round_away((m.to(torch.float32) - zi) * ratio) + zo
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _op_mean(graph, op, dev) -> Step:
    # TFLite integer Mean: acc = sum(q - zp_in); MBQM(acc, si / (n * so)) + zp_out.
    i, o = op.inputs[0], op.outputs[0]
    axes, keep = _reduce_axes(graph, op), op.options["keepdims"]
    si, zi = _sz(graph, i)
    so, zo = _sz(graph, o)

    def step(v):
        x = v[i]
        num = math.prod(x.shape[a] for a in axes)
        acc = (x.to(torch.int64) - zi).sum(dim=axes, keepdim=keep)
        q = _mbqm_fn(*_quantize_multiplier(si / (num * so)), dev)(acc) + zo
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _op_logistic(graph, op, dev) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    si, zi = _sz(graph, i)
    zo = _sz(graph, o)[1]
    so = graph.tensors[o].scale[0]  # numpy float64, as the JAX package divides by it
    vals = np.arange(-128, 128, dtype=np.float64)
    f = 1.0 / (1.0 + np.exp(-(vals - zi) * si))
    lut = np.clip(np.sign(f / so) * np.floor(np.abs(f / so) + 0.5) + zo,
                  -128, 127).astype(np.int8)
    lut = torch.as_tensor(lut, device=dev)

    def step(v):
        v[o] = lut[v[i].to(torch.int64) + 128]
    return step


_OPS = {
    "QUANTIZE": _op_quantize,
    "DEQUANTIZE": _op_dequantize,
    "TRANSPOSE": _op_transpose,
    "STRIDED_SLICE": _op_strided_slice,
    "RESHAPE": _op_reshape,
    "CONV_2D": _op_conv,
    "DEPTHWISE_CONV_2D": _op_conv,
    "FULLY_CONNECTED": _op_fully_connected,
    "ADD": _op_add,
    "MUL": _op_mul,
    "DIV": _op_div,
    "REDUCE_MAX": _op_reduce_max,
    "MEAN": _op_mean,
    "LOGISTIC": _op_logistic,
}


def build_executor(graph: TFLiteGraph, batch_size: int, device: str | torch.device = "cuda",
                   return_all: bool = False, requant: str = "exact",
                   pretransposed_input: bool = False,
                   prequantized_input: bool = False) -> Callable[[torch.Tensor], Any]:
    """Build f(x) mapping one input batch to the graph's output on `device`.

    Args:
        graph: Parsed model. The single subgraph input must be float32.
        batch_size: The batch the executor runs (x.shape[0]).
        device: Where weights live and the graph runs; default CUDA.
        return_all: Return {tensor index: value} instead of the output.
        requant: 'exact' only ('fast' is not ported yet).
        pretransposed_input: x comes in the entry TRANSPOSE's output
            orientation (entry_transpose_perm); it is quantized directly
            and the transpose is skipped.
        prequantized_input: x IS the int8 entry tensor in that orientation,
            quantized by a producer with entry_quant_params(graph) (the
            fused frontend kernel's int8 epilogue).

    Returns:
        f(x: [B, ...] float32, or int8 with prequantized_input) -> [B, ...]
        float32, on `device`.
    """
    if requant != "exact":
        raise NotImplementedError(f"requant={requant!r} is not ported yet "
                                  "(ROADMAP.md, Queue 1: requant='fast')")
    dev = resolve_device(device)
    entry_skip: set[int] = set()
    entry_target = None
    if pretransposed_input or prequantized_input:
        if entry_transpose_perm(graph) is None:
            raise ValueError("graph does not start with QUANTIZE -> TRANSPOSE")
        entry_skip = {0, 1}
        entry_target = graph.ops[1].outputs[0]

    steps = []
    for op_index, op in enumerate(graph.ops):
        if op_index in entry_skip:
            continue
        if op.name not in _OPS:
            raise NotImplementedError(f"TFLite op {op.name}: {_NOT_PORTED}")
        steps.append(_OPS[op.name](graph, op, dev))
    consts = {t.index: torch.as_tensor(t.data.copy(), device=dev)
              for t in graph.tensors if t.data is not None}
    if entry_target is not None and not prequantized_input:
        s0, z0 = _sz(graph, graph.ops[0].outputs[0])
        inv0 = f32_reciprocal(s0, dev)
    want = torch.int8 if prequantized_input else torch.float32

    @torch.no_grad()
    def executor(x: torch.Tensor):
        if x.shape[0] != batch_size or x.dtype != want or x.device != dev:
            raise ValueError(f"executor for {batch_size} x {want} on {dev} got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        vals = dict(consts)
        if prequantized_input:
            vals[entry_target] = x
        elif entry_target is not None:
            # x is in the transpose-output orientation; quantize is
            # elementwise, so quantizing it == transpose(quantize(x')).
            vals[entry_target] = quantize_f32(x, inv0, z0)
        else:
            vals[graph.inputs[0]] = x
        with full_fp32():
            for step in steps:
                step(vals)
        return vals if return_all else vals[graph.outputs[0]]

    return executor
