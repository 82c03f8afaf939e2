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
- requant="fast" (opt-in, as in the JAX package) replaces the convolutions'
  and FULLY_CONNECTED's requantization by round_half_away(float32(acc) *
  float32(multiplier)) + zp, one plain float32 multiply, and the int8 ->
  int8 QUANTIZE by its float form; it is bit-equal to the JAX fast path;
- float steps (the entry QUANTIZE, DIV, DEQUANTIZE, SOFTMAX, a CONCATENATION
  or MAXIMUM / MINIMUM whose inputs are quantized differently) repeat the
  jitted JAX float32 arithmetic. XLA turns a division by a constant into a
  multiply by its float32 reciprocal, so these multiply by an explicit
  float32 reciprocal tensor; never divide a CUDA tensor by a Python scalar,
  which ATen also turns into a reciprocal multiply, computed differently.
  SOFTMAX's exp and sum are the device's own: one ulp there can move an
  output code against XLA's;
- LOGISTIC and LOG are 256-entry lookup tables built on the host in float64;
- SHAPE, PACK and STRIDED_SLICE / RESHAPE / FILL over their results are
  host values (numpy arrays in the executor's value table), as the JAX
  executor keeps them on the host.

The executor runs every op kind of the JAX executor: QUANTIZE, DEQUANTIZE,
TRANSPOSE, SHAPE, PACK, FILL, STRIDED_SLICE (strides, masks), CONCATENATION,
CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED, ADD, SUB, MEAN, MUL, DIV,
REDUCE_MAX, SUM, RESHAPE, PAD, PADV2, SOFTMAX, LOGISTIC, LOG, MAXIMUM and
MINIMUM; any other raises NotImplementedError. Before it builds the steps it
runs the JAX package's layout pre-passes (`layout_plan`), which change no
value: a 4-D TRANSPOSE whose value reaches one convolution through identity
STRIDED_SLICEs is aliased and the convolution reads the untransposed
tensor; a CONCATENATION of a tensor and a constant (a const tensor, or the
FILL of a const scalar) feeding one 1x1 CONV_2D is folded into that conv's
int32 bias, and a FILL that fed only folded CONCATENATIONs is not run.
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

REQUANT_MODES = ("exact", "fast")

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


def _requant_fn(multipliers, zp: int, lo: int, hi: int, device: torch.device,
                requant: str = "exact"):
    """int64 accumulator [..., C] -> int8 codes, clamped to the activation
    bounds: 'exact' is the per-channel MBQM by each multiplier, + zp;
    'fast' is round_half_away(float32(acc) * float32(multiplier)) + zp
    (the JAX package's _requant_fast: one plain float32 multiply, at most
    one LSB from exact per op)."""
    if requant == "fast":
        m = torch.as_tensor(np.atleast_1d(multipliers).astype(np.float32), device=device)
        return lambda acc: torch.clamp(
            _round_away(acc.to(torch.float32) * m).to(torch.int32) + zp, lo, hi).to(torch.int8)
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


# --- Layout pre-passes --------------------------------------------------------


@dataclass
class LayoutPlan:
    """What the JAX executor's layout pre-passes (tflite_import.py:683-837)
    decide for a graph. None of it changes a value.

    alias_ops: op index -> the tensor it forwards unchanged (an elided
        TRANSPOSE, an identity STRIDED_SLICE or a folded CONCATENATION of
        its chain, any folded CONCATENATION).
    pending_perm: tensor -> the perm of the TRANSPOSE it was elided from;
        the value held is the untransposed one, and its consumer (a
        convolution, or SHAPE) applies the perm.
    concat_fold: CONCATENATION output -> (leading channels, pad code) for
        the 1x1 CONV_2D that consumes it, which reads the unpadded tensor
        with the leading weight channels and adds the pad channels'
        constant contribution to its int32 bias.
    dead_ops: FILL ops whose output feeds only folded CONCATENATIONs (the
        port's eager executor would otherwise launch them for nothing).
    """

    alias_ops: dict[int, int] = field(default_factory=dict)
    pending_perm: dict[int, tuple] = field(default_factory=dict)
    concat_fold: dict[int, tuple[int, int]] = field(default_factory=dict)
    dead_ops: set[int] = field(default_factory=set)


def _consumers(graph: TFLiteGraph) -> dict[int, list[int]]:
    cons: dict[int, list[int]] = {}
    for i, op in enumerate(graph.ops):
        for t in op.inputs:
            cons.setdefault(t, []).append(i)
    return cons


def _fold_concat(graph: TFLiteGraph, op: OpInfo, cons: dict) -> tuple[int, int] | None:
    """(leading channels, pad code) when `op` (a CONCATENATION) pads its
    first input's channels with a constant (a uniform const tensor, or the
    FILL of a const scalar) for exactly one 1x1 CONV_2D, else None."""
    if len(op.inputs) != 2:
        return None
    t_dyn, t_pad = op.inputs
    out = op.outputs[0]
    info_out = graph.tensors[out]
    if (info_out.dtype != "int8" or len(info_out.shape) != 4
            or op.options["axis"] not in (3, -1)
            or op.options.get("activation", _ACT_NONE) != _ACT_NONE):
        return None
    so, zo = _sz(graph, out)
    if _sz(graph, t_dyn) != (so, zo):
        return None  # the pass-through part would need requantization
    tp = graph.tensors[t_pad]
    pad_code = None
    if tp.data is not None:
        d = np.asarray(tp.data)
        if np.all(d == d.flat[0]):
            pad_code = int(d.flat[0])
    else:
        prod = [j for j, p in enumerate(graph.ops) if t_pad in p.outputs]
        if len(prod) == 1 and graph.ops[prod[0]].name == "FILL":
            value = graph.tensors[graph.ops[prod[0]].inputs[1]].data
            if value is not None:
                pad_code = int(np.asarray(value).reshape(()))
    if pad_code is None:
        return None
    sp, zp = _sz(graph, t_pad)
    if (sp, zp) != (so, zo):
        # Requantize the constant as ConcatenationWithScaling would (the
        # CONCATENATION step's float32 association).
        inv_so = np.float32(1.0) / np.float32(so)
        scale = np.float32(sp) * inv_so
        f = np.float32(pad_code) * scale + np.float32(-zp) * scale
        pad_code = int(np.clip(np.sign(f) * np.floor(np.abs(f) + np.float32(0.5)) + zo,
                               -128, 127))
    users = cons.get(out, [])
    if any(graph.ops[c].name == "SHAPE" for c in users):
        return None  # SHAPE would observe the unpadded physical shape
    if out in graph.outputs or len(users) != 1:
        return None
    nxt = graph.ops[users[0]]
    wt = graph.tensors[nxt.inputs[1]] if len(nxt.inputs) > 1 else None
    if (nxt.name != "CONV_2D" or nxt.inputs[0] != out or wt is None or wt.data is None
            or wt.shape[1] != 1 or wt.shape[2] != 1):
        return None  # only 1x1 convs: no boundary-padding interaction
    return int(graph.tensors[t_dyn].shape[-1]), pad_code


def _slice_is_identity(graph: TFLiteGraph, op: OpInfo) -> bool:
    """Whether a STRIDED_SLICE with constant bounds keeps all of its input."""
    t_in, t_out = graph.tensors[op.inputs[0]], graph.tensors[op.outputs[0]]
    if t_in.shape != t_out.shape or op.options.get("shrink_axis_mask"):
        return False
    if any(graph.tensors[op.inputs[k]].data is None for k in (1, 2, 3)):
        return False  # dynamic bounds: identity cannot be proved
    if op.options.get("ellipsis_mask") or op.options.get("new_axis_mask"):
        return False
    begin, end, strides = (np.asarray(graph.tensors[op.inputs[k]].data) for k in (1, 2, 3))
    if min(len(begin), len(end), len(strides)) < len(t_in.shape):
        return False
    bm, em = op.options["begin_mask"], op.options["end_mask"]
    for d, dim in enumerate(t_in.shape):
        b = 0 if (bm >> d) & 1 else int(begin[d])
        e = dim if (em >> d) & 1 else int(end[d])
        if b != 0 or e != dim or int(strides[d]) != 1:
            return False
    return True


def layout_plan(graph: TFLiteGraph, entry_target: int | None = None) -> LayoutPlan:
    """The layout pre-passes of the JAX executor for `graph`: transpose
    elision, identity STRIDED_SLICE aliasing inside an elided chain, the
    CONCAT-of-FILL channel-pad fold and the FILL-producer check. With
    `entry_target` (the entry TRANSPOSE's output, under pretransposed or
    prequantized input) the chain rooted at the entry TRANSPOSE keeps its
    aliases but applies no perm: its input arrives transposed already."""
    plan = LayoutPlan()
    cons = _consumers(graph)
    folded = set()
    for i, op in enumerate(graph.ops):
        if op.name == "CONCATENATION":
            fold = _fold_concat(graph, op, cons)
            if fold is not None:
                plan.concat_fold[op.outputs[0]] = fold
                folded.add(i)

    chains = []
    for i, op in enumerate(graph.ops):
        if op.name != "TRANSPOSE" or graph.tensors[op.inputs[1]].data is None:
            continue
        perm = tuple(int(p) for p in graph.tensors[op.inputs[1]].data)
        if len(perm) != 4 or perm[0] != 0:
            continue
        chain, t, ok = [i], op.outputs[0], False
        while True:
            # SHAPE reports the logical shape of a perm-pending tensor, so it
            # does not block the chain; a graph output does.
            users = [c for c in cons.get(t, []) if graph.ops[c].name != "SHAPE"]
            if len(users) != 1 or t in graph.outputs:
                break
            nxt = graph.ops[users[0]]
            if nxt.inputs[0] == t and (users[0] in folded or (
                    nxt.name == "STRIDED_SLICE" and _slice_is_identity(graph, nxt))):
                chain.append(users[0])
                t = nxt.outputs[0]
                continue
            ok = nxt.name in ("CONV_2D", "DEPTHWISE_CONV_2D") and nxt.inputs[0] == t
            break
        if ok:
            chains.append(chain)
            for ci in chain:
                plan.alias_ops[ci] = graph.ops[ci].inputs[0]
                plan.pending_perm[graph.ops[ci].outputs[0]] = perm
    for i in folded:
        plan.alias_ops[i] = graph.ops[i].inputs[0]

    if entry_target is not None:
        plan.alias_ops.pop(1, None)
        for chain in chains:
            if chain[0] == 1:
                for ci in chain:
                    plan.pending_perm.pop(graph.ops[ci].outputs[0], None)
        plan.pending_perm.pop(entry_target, None)

    for i, op in enumerate(graph.ops):
        users = cons.get(op.outputs[0], [])
        if (op.name == "FILL" and users and all(c in folded for c in users)
                and op.outputs[0] not in graph.outputs):
            plan.dead_ops.add(i)
    return plan


# --- Ops -----------------------------------------------------------------------
#
# Each _op_* function runs once per executor, on the host: it reads the op's
# constants, uploads what the op needs to the device and returns
# step(vals), which reads the op's inputs from `vals` (tensor index ->
# torch tensor, or numpy array for a host value) and stores its output there.

Step = Callable[[dict], None]


@dataclass
class _Build:
    """What every _op_* function reads: the graph, the device, the requant mode
    and the layout plan."""

    graph: TFLiteGraph
    dev: torch.device
    requant: str
    plan: LayoutPlan


def _sz(graph: TFLiteGraph, idx: int) -> tuple[float, int]:
    t = graph.tensors[idx]
    return float(t.scale[0]), int(t.zero_point[0])


def _host_const(graph: TFLiteGraph, idx: int, what: str) -> np.ndarray:
    data = graph.tensors[idx].data
    if data is None:
        raise NotImplementedError(f"{what} from a computed tensor {idx} is not supported")
    return np.asarray(data)


def _host(graph: TFLiteGraph, vals: dict, idx: int) -> np.ndarray:
    """A host value at run time: computed (SHAPE, PACK, a slice of them) or
    a constant's buffer."""
    x = vals.get(idx)
    if isinstance(x, np.ndarray):
        return x
    return _host_const(graph, idx, "host value")


def _gemm_dtype(w: np.ndarray, tap_axes: tuple) -> torch.dtype:
    """float32 when every partial sum of int8 codes times `w` is exact in it
    (sum |w| * 255 < 2^24 for every output channel), else float64."""
    bound = int(np.abs(w.astype(np.int64)).sum(axis=tap_axes).max()) * 255
    return torch.float32 if bound < (1 << 24) else torch.float64


def _op_quantize(c: _Build, op) -> Step:
    graph, dev = c.graph, c.dev
    i, o = op.inputs[0], op.outputs[0]
    s, z = _sz(graph, o)
    if graph.tensors[i].dtype == "float32":
        inv = f32_reciprocal(s, dev)

        def step(v):
            v[o] = quantize_f32(v[i], inv, z)
        return step
    si, zi = _sz(graph, i)
    if c.requant == "fast":
        # The JAX fast form: round_away((x - zi) * float32(si / s)) + z.
        ratio = _f32_const(si / s, dev)

        def step(v):
            q = _round_away((v[i].to(torch.float32) - zi) * ratio) + z
            v[o] = torch.clamp(q, -128, 127).to(torch.int8)
        return step
    # int8 -> int8: TFLite's Requantize, MBQM(x - zi, qm, shift) + zo.
    mbqm = _mbqm_fn(*_quantize_multiplier(si / s), dev)

    def step(v):
        q = mbqm(v[i].to(torch.int64) - zi) + z
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _op_dequantize(c: _Build, op) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    s, z = _sz(c.graph, i)
    s32 = _f32_const(s, c.dev)

    def step(v):
        v[o] = (v[i].to(torch.float32) - z) * s32
    return step


def _op_transpose(c: _Build, op) -> Step:
    i, o = op.inputs[0], op.outputs[0]
    perm = tuple(int(p) for p in _host_const(c.graph, op.inputs[1], "TRANSPOSE perm"))

    def step(v):
        v[o] = v[i].permute(perm)
    return step


def _op_shape(c: _Build, op) -> Step:
    # A host value: the logical shape (a perm-pending tensor holds its
    # untransposed value).
    i, o = op.inputs[0], op.outputs[0]
    perm = c.plan.pending_perm.get(i)

    def step(v):
        phys = tuple(v[i].shape)
        shape = phys if perm is None else tuple(phys[p] for p in perm)
        v[o] = np.asarray(shape, np.int32)
    return step


def _op_pack(c: _Build, op) -> Step:
    # Packs host scalars into a host vector (shape arithmetic).
    o = op.outputs[0]

    def step(v):
        parts = [_host(c.graph, v, i).reshape(()) for i in op.inputs]
        v[o] = np.stack(parts).astype(np.int32)
    return step


def _op_fill(c: _Build, op) -> Step:
    graph, dev = c.graph, c.dev
    o = op.outputs[0]
    int8 = graph.tensors[o].dtype == "int8"

    def step(v):
        dims = tuple(int(d) for d in _host(graph, v, op.inputs[0]))
        value = _host(graph, v, op.inputs[1]).reshape(())
        dtype = torch.int8 if int8 else torch.from_numpy(np.asarray(value)).dtype
        v[o] = torch.full(dims, value.item(), dtype=dtype, device=dev)
    return step


def _slice_tensor(x: torch.Tensor, slices: tuple) -> torch.Tensor:
    """x[slices] with numpy's semantics; torch's own indexing takes positive
    steps only, so a negative step gathers its indices."""
    if all(isinstance(s, int) or (s.step or 1) > 0 for s in slices):
        return x[slices]
    dim = 0
    for s in slices:
        if isinstance(s, int):
            x = x.select(dim, s)
            continue
        idx = torch.arange(*s.indices(x.shape[dim]), device=x.device)
        x = x.index_select(dim, idx)
        dim += 1
    return x


def _op_strided_slice(c: _Build, op) -> Step:
    graph = c.graph
    i, o = op.inputs[0], op.outputs[0]
    opts = op.options
    if opts.get("new_axis_mask") or opts.get("ellipsis_mask"):
        raise NotImplementedError(
            "STRIDED_SLICE with new_axis/ellipsis masks is not supported")
    bm, em, sm = opts["begin_mask"], opts["end_mask"], opts["shrink_axis_mask"]
    src_shape = graph.tensors[i].shape

    def slices(v, on_host: bool) -> tuple:
        begin, end, strides = ([int(x) for x in _host(graph, v, k)] for k in op.inputs[1:4])
        out = []
        for d in range(len(begin)):
            b = None if (bm >> d) & 1 else begin[d]
            e = None if (em >> d) & 1 else end[d]
            if (d == 0 and not on_host and b in (None, 0) and e == 1 and src_shape
                    and src_shape[0] == 1):
                # A literal batch-1 end from a batch-1 export means "the
                # whole batch": remap it to the executor's batch, as
                # RESHAPE does.
                e = None
            out.append(begin[d] if (sm >> d) & 1 else slice(b, e, strides[d]))
        return tuple(out)

    def step(v):
        x = v[i]
        if isinstance(x, np.ndarray):
            v[o] = np.asarray(x[slices(v, True)])
        else:
            v[o] = _slice_tensor(x, slices(v, False))
    return step


def _op_reshape(c: _Build, op) -> Step:
    graph = c.graph
    i, o = op.inputs[0], op.outputs[0]
    has_shape = len(op.inputs) > 1 and op.inputs[1] >= 0

    def step(v):
        src = v[i]
        new_shape = ([int(d) for d in _host(graph, v, op.inputs[1])] if has_shape
                     else [int(d) for d in op.options["new_shape"]])
        # A spec exported at batch 1 may carry a literal leading 1: remap it
        # to -1, or to the real batch when the spec's -1 is elsewhere.
        if new_shape and new_shape[0] not in (-1, src.shape[0]):
            new_shape[0] = -1 if -1 not in new_shape[1:] else src.shape[0]
        v[o] = src.reshape(new_shape)
    return step


def _op_concatenation(c: _Build, op) -> Step:
    graph, dev = c.graph, c.dev
    o = op.outputs[0]
    axis = op.options["axis"]
    so, zo = _sz(graph, o)
    parts = []
    for i in op.inputs:
        si, zi = _sz(graph, i)
        if (si, zi) == (so, zo):
            parts.append(lambda v, i=i: v[i])
            continue
        # TFLite ConcatenationWithScaling: float32 with a precomputed inverse
        # output scale, round(x * scale + bias) + zo, in that association.
        scale = np.float32(si) * (np.float32(1.0) / np.float32(so))
        sc, bi = _f32_const(scale, dev), _f32_const(np.float32(-zi) * scale, dev)
        parts.append(lambda v, i=i, sc=sc, bi=bi: torch.clamp(
            _round_away(v[i].to(torch.float32) * sc + bi) + zo, -128, 127).to(torch.int8))
    act = op.options.get("activation", _ACT_NONE)
    lo, hi = _act_bounds(act, so, zo)

    def step(v):
        cat = torch.cat([part(v) for part in parts], dim=axis)
        v[o] = cat if act == _ACT_NONE else torch.clamp(cat, lo, hi)
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


def _op_conv(c: _Build, op) -> Step:
    graph, dev = c.graph, c.dev
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
    requant = _requant_fn(si * sw.astype(np.float64) / so, zo, lo, hi, dev, c.requant)
    depthwise = name == "DEPTHWISE_CONV_2D"
    kh, kw = w.shape[1], w.shape[2]
    c_in = graph.tensors[i].shape[3]  # the logical NHWC shape
    # An elided TRANSPOSE: the value is untransposed, apply its perm here.
    perm = c.plan.pending_perm.get(i)
    if perm is None:
        def x_in(v):
            return v[i]
    else:
        def x_in(v):
            return v[i].permute(perm)
    # A folded constant-pad CONCATENATION: read the unpadded tensor with the
    # leading weight channels; the pad channels' constant contribution
    # joins the bias correction.
    pad_corr = 0
    fold = c.plan.concat_fold.get(i) if not depthwise else None
    if fold is not None:
        n_lead, pad_code = fold
        pad_corr = w[:, :, :, n_lead:].astype(np.int64).sum(axis=(1, 2, 3)) * (pad_code - zi)
        w, c_in = w[:, :, :, :n_lead], n_lead

    if depthwise and kh == kw == 1 and (sh, swd) == (1, 1) and dil == (1, 1) \
            and w.shape[0] == 1 and w.shape[3] == c_in:
        # 1x1 stride-1 depthwise conv == per-channel affine:
        # acc[..., c] = w_c * (x - zp) + bias_c (PWL/PCEN frontend encodings).
        wv = torch.as_tensor(w.reshape(-1).astype(np.int64), device=dev)
        bv = torch.as_tensor(np.broadcast_to(bias, w.shape[3:]).copy(), device=dev)

        def step(v):
            v[o] = requant((x_in(v).to(torch.int64) - zi) * wv + bv)
        return step

    tap_axes = (0, 1, 2) if depthwise else (1, 2, 3)
    w_sum = w.astype(np.int64).sum(axis=tap_axes)
    # The zero-point fold: padding with zi makes sum w * (x - zi) exact.
    correction = torch.as_tensor(bias - zi * w_sum + pad_corr, dtype=torch.int64, device=dev)

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
            xp = padded(x_in(v)).to(torch.int32)
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
            x = x_in(v)[:, ::sh, ::swd, :]
            acc = (x.to(gemm) @ wt).to(torch.int64)
            v[o] = requant(acc + correction)
        return step

    # Any other CONV_2D: unfold the zero-point-padded input into taps
    # (channel-major, as unfold orders them) and multiply.
    wt = torch.as_tensor(np.transpose(w, (3, 1, 2, 0)).reshape(-1, O).copy(),
                         dtype=gemm, device=dev)  # [I*kh*kw, O]

    def step(v):
        xp = padded(x_in(v))
        Ho, Wo = out_hw(xp)
        cols = F.unfold(xp.to(gemm).permute(0, 3, 1, 2), (kh, kw), dilation=dil,
                        stride=(sh, swd))  # [B, I*kh*kw, Ho*Wo]
        acc = (cols.transpose(1, 2) @ wt).to(torch.int64)
        v[o] = requant(acc.reshape(xp.shape[0], Ho, Wo, O) + correction)
    return step


def _op_fully_connected(c: _Build, op) -> Step:
    graph, dev = c.graph, c.dev
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
    requant = _requant_fn(si * sw.astype(np.float64) / so, zo, lo, hi, dev, c.requant)
    gemm = _gemm_dtype(w, (1,))
    wt = torch.as_tensor(w.T.copy(), dtype=gemm, device=dev)  # [in, out]
    correction = torch.as_tensor(bias - zi * w.astype(np.int64).sum(axis=1),
                                 dtype=torch.int64, device=dev)

    def step(v):
        acc = (v[i].to(gemm) @ wt).to(torch.int64)
        v[o] = requant(acc + correction)
    return step


def _op_add_sub(c: _Build, op) -> Step:
    # TFLite int8 ADD / SUB: rescale both inputs to twice the larger input
    # scale at 20 fractional bits, add or subtract, requantize. A constant
    # operand is rescaled once, on the host.
    graph, dev = c.graph, c.dev
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
    sign = 1 if op.name == "ADD" else -1

    def step(v):
        raw = ra(v) + rb(v) if sign > 0 else ra(v) - rb(v)
        v[o] = torch.clamp(out(raw) + zo, lo, hi).to(torch.int8)
    return step


def _op_mul(c: _Build, op) -> Step:
    # TFLite int8 MUL: the product of the offset codes, one MBQM.
    graph, dev = c.graph, c.dev
    (a, b), o = op.inputs[:2], op.outputs[0]
    sa, za = _sz(graph, a)
    sb, zb = _sz(graph, b)
    so, zo = _sz(graph, o)

    def offset(idx, zp):
        data = graph.tensors[idx].data
        if data is not None:
            k = torch.as_tensor(np.asarray(data, np.int64) - zp, device=dev)
            return lambda v: k
        return lambda v: v[idx].to(torch.int64) - zp

    fa, fb_ = offset(a, za), offset(b, zb)
    mbqm = _mbqm_fn(*_quantize_multiplier(sa * sb / so), dev)
    lo, hi = _act_bounds(op.options["activation"], so, zo)

    def step(v):
        v[o] = torch.clamp(mbqm(fa(v) * fb_(v)) + zo, lo, hi).to(torch.int8)
    return step


def _dequant_f32(graph: TFLiteGraph, idx: int, dev: torch.device):
    """v -> (code - zp) * float32(scale): the JAX executor's float reads."""
    s, z = _sz(graph, idx)
    s32 = _f32_const(s, dev)
    return lambda v: (v[idx].to(torch.float32) - z) * s32


def _op_div(c: _Build, op) -> Step:
    # Float-faithful, as the JAX package: dequantize both, divide, multiply
    # by the float32 reciprocal of the output scale, round half away.
    (a, b), o = op.inputs[:2], op.outputs[0]
    fa, fb_ = _dequant_f32(c.graph, a, c.dev), _dequant_f32(c.graph, b, c.dev)
    so, zo = _sz(c.graph, o)
    inv_so = f32_reciprocal(so, c.dev)
    lo, hi = _act_bounds(op.options["activation"], so, zo)

    def step(v):
        q = _round_away(fa(v) / fb_(v) * inv_so) + zo
        v[o] = torch.clamp(q, lo, hi).to(torch.int8)
    return step


def _op_maximum_minimum(c: _Build, op) -> Step:
    # TFLite's quantized Maximum / Minimum compares the raw codes when every
    # tensor shares its quantization; otherwise float-faithful (<= 1 LSB),
    # as the JAX package.
    graph, dev = c.graph, c.dev
    (a, b), o = op.inputs[:2], op.outputs[0]
    fn = torch.maximum if op.name == "MAXIMUM" else torch.minimum
    so, zo = _sz(graph, o)
    if _sz(graph, a) == _sz(graph, b) == (so, zo):
        def step(v):
            v[o] = fn(v[a], v[b])
        return step
    fa, fb_ = _dequant_f32(graph, a, dev), _dequant_f32(graph, b, dev)
    inv_so = f32_reciprocal(so, dev)

    def step(v):
        q = _round_away(fn(fa(v), fb_(v)) * inv_so) + zo
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _reduce_axes(graph, op) -> tuple:
    return tuple(int(x) for x in np.atleast_1d(_host_const(graph, op.inputs[1], "axes")))


def _op_reduce_max(c: _Build, op) -> Step:
    graph = c.graph
    i, o = op.inputs[0], op.outputs[0]
    axes, keep = _reduce_axes(graph, op), op.options.get("keepdims", True)
    si, zi = _sz(graph, i)
    so, zo = _sz(graph, o)
    if si == so and zi == zo:
        def step(v):
            v[o] = v[i].amax(dim=axes, keepdim=keep)
        return step
    ratio = _f32_const(si / so, c.dev)

    def step(v):
        m = v[i].amax(dim=axes, keepdim=keep)
        q = _round_away((m.to(torch.float32) - zi) * ratio) + zo
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _op_mean_sum(c: _Build, op) -> Step:
    # TFLite integer Mean: acc = sum(q - zp_in); MBQM(acc, si / (n * so)) +
    # zp_out. SUM is the same without the 1 / n.
    graph, dev = c.graph, c.dev
    i, o = op.inputs[0], op.outputs[0]
    axes = _reduce_axes(graph, op)
    mean = op.name == "MEAN"
    keep = op.options["keepdims"] if mean else op.options.get("keepdims", False)
    si, zi = _sz(graph, i)
    so, zo = _sz(graph, o)

    def step(v):
        x = v[i]
        num = math.prod(x.shape[a] for a in axes) if mean else 1
        acc = (x.to(torch.int64) - zi).sum(dim=axes, keepdim=keep)
        q = _mbqm_fn(*_quantize_multiplier(si / (num * so)), dev)(acc) + zo
        v[o] = torch.clamp(q, -128, 127).to(torch.int8)
    return step


def _op_pad(c: _Build, op) -> Step:
    # TFLite Pad: constant padding with the output zero point for quantized
    # tensors, 0.0 for float ones, or PADV2's explicit constant.
    graph = c.graph
    i, o = op.inputs[0], op.outputs[0]
    pads = _host_const(graph, op.inputs[1], "PAD paddings").astype(np.int64).reshape(-1, 2)
    flat = [int(p) for before_after in pads[::-1] for p in before_after]  # last dim first
    if op.name == "PADV2" and len(op.inputs) > 2 and op.inputs[2] >= 0:
        value = _host_const(graph, op.inputs[2], "PADV2 value").reshape(()).item()
    elif graph.tensors[i].dtype == "float32":
        value = 0.0
    else:
        value = _sz(graph, o)[1]

    def step(v):
        v[o] = F.pad(v[i], flat, value=value)
    return step


def _op_softmax(c: _Build, op) -> Step:
    # Float-faithful softmax(beta * x) over the last axis, as the JAX
    # executor computes it (exp(x - max) / sum); the int8 output scale is
    # 1/256.
    graph, dev = c.graph, c.dev
    i, o = op.inputs[0], op.outputs[0]
    f = _dequant_f32(graph, i, dev)
    beta = _f32_const(op.options.get("beta", 1.0), dev)
    so, zo = _sz(graph, o)
    inv_so = f32_reciprocal(so, dev)

    def step(v):
        x = beta * f(v)
        e = torch.exp(x - x.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        v[o] = torch.clamp(_round_away(p * inv_so) + zo, -128, 127).to(torch.int8)
    return step


def _lut_step(c: _Build, op, f_of_x) -> Step:
    """An int8 elementwise op as a 256-entry table built on the host in
    float64: round half away, + zp, clamp (TFLite's LUTPopulate)."""
    i, o = op.inputs[0], op.outputs[0]
    si, zi = _sz(c.graph, i)
    zo = _sz(c.graph, o)[1]
    so = c.graph.tensors[o].scale[0]  # numpy float64, as the JAX package divides by it
    f = f_of_x((np.arange(-128, 128, dtype=np.float64) - zi) * si)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.sign(f / so) * np.floor(np.abs(f / so) + 0.5) + zo
    lut = np.clip(np.nan_to_num(q, nan=-128.0, neginf=-128.0), -128, 127).astype(np.int8)
    lut = torch.as_tensor(lut, device=c.dev)

    def step(v):
        v[o] = lut[v[i].to(torch.int64) + 128]
    return step


def _op_logistic(c: _Build, op) -> Step:
    return _lut_step(c, op, lambda x: 1.0 / (1.0 + np.exp(-x)))


def _op_log(c: _Build, op) -> Step:
    # Non-positive dequants map to qmin: the graph clamps with MAXIMUM(x,
    # eps) first (the db magnitude scaling).
    def log(x):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(x > 0.0, np.log(x), -np.inf)
    return _lut_step(c, op, log)


_OPS = {
    "QUANTIZE": _op_quantize,
    "DEQUANTIZE": _op_dequantize,
    "TRANSPOSE": _op_transpose,
    "SHAPE": _op_shape,
    "PACK": _op_pack,
    "FILL": _op_fill,
    "STRIDED_SLICE": _op_strided_slice,
    "CONCATENATION": _op_concatenation,
    "RESHAPE": _op_reshape,
    "CONV_2D": _op_conv,
    "DEPTHWISE_CONV_2D": _op_conv,
    "FULLY_CONNECTED": _op_fully_connected,
    "ADD": _op_add_sub,
    "SUB": _op_add_sub,
    "MUL": _op_mul,
    "DIV": _op_div,
    "REDUCE_MAX": _op_reduce_max,
    "MEAN": _op_mean_sum,
    "SUM": _op_mean_sum,
    "PAD": _op_pad,
    "PADV2": _op_pad,
    "SOFTMAX": _op_softmax,
    "LOGISTIC": _op_logistic,
    "LOG": _op_log,
    "MAXIMUM": _op_maximum_minimum,
    "MINIMUM": _op_maximum_minimum,
}


def build_executor(graph: TFLiteGraph, batch_size: int, device: str | torch.device = "cuda",
                   return_all: bool = False, requant: str = "exact",
                   pretransposed_input: bool = False,
                   prequantized_input: bool = False,
                   layout_prepasses: bool = True) -> Callable[[torch.Tensor], Any]:
    """Build f(x) mapping one input batch to the graph's output on `device`.

    Args:
        graph: Parsed model. The single subgraph input must be float32.
        batch_size: The batch the executor runs (x.shape[0]).
        device: Where weights live and the graph runs; default CUDA.
        return_all: Return {tensor index: value} instead of the output.
        requant: 'exact' (bit-exact TFLite fixed-point requantization) or
            'fast' (float32-multiply requantization, <= 1 LSB per op, and the
            flips cascade; opt-in only, as in the JAX package).
        pretransposed_input: x comes in the entry TRANSPOSE's output
            orientation (entry_transpose_perm); it is quantized directly
            and the transpose is skipped.
        prequantized_input: x IS the int8 entry tensor in that orientation,
            quantized by a producer with entry_quant_params(graph) (the
            fused frontend kernel's int8 epilogue).
        layout_prepasses: Run the layout pre-passes (`layout_plan`); False
            runs every op as the graph lists it, the same values.

    Returns:
        f(x: [B, ...] float32, or int8 with prequantized_input) -> [B, ...]
        float32, on `device`. f.steps is the number of ops it computes
        (aliased, skipped and dead ops not counted).
    """
    if requant not in REQUANT_MODES:
        raise ValueError(f"Invalid requant: {requant!r} (expected one of {REQUANT_MODES})")
    dev = resolve_device(device)
    entry_skip: set[int] = set()
    entry_target = None
    if pretransposed_input or prequantized_input:
        if entry_transpose_perm(graph) is None:
            raise ValueError("graph does not start with QUANTIZE -> TRANSPOSE")
        entry_skip = {0, 1}
        entry_target = graph.ops[1].outputs[0]
    plan = layout_plan(graph, entry_target) if layout_prepasses else LayoutPlan()
    build = _Build(graph, dev, requant, plan)

    steps, n_compute = [], 0
    for op_index, op in enumerate(graph.ops):
        if op_index in entry_skip or op_index in plan.dead_ops:
            continue
        if op.name not in _OPS:
            raise NotImplementedError(f"TFLite op {op.name} not supported")
        if op_index in plan.alias_ops:
            # Forward the input unchanged; the consumer applies any perm.
            src, dst = plan.alias_ops[op_index], op.outputs[0]
            steps.append(lambda v, src=src, dst=dst: v.__setitem__(dst, v[src]))
            continue
        steps.append(_OPS[op.name](build, op))
        n_compute += 1
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

    executor.steps = n_compute
    return executor


def load_tflite_model(path, batch_size: int = 1, device: str | torch.device = "cuda"):
    """Parse a .tflite file and return (graph, executor for `batch_size` on
    `device`)."""
    graph = TFLiteGraph(path)
    return graph, build_executor(graph, batch_size, device=device)
