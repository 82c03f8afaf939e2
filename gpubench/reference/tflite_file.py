"""A small reader of .tflite files for the benchmark's INT8 reference: the
first subgraph's tensors (shape, type, quantization, constant data) and its
operators with the options of the op kinds int8.py runs.

A .tflite file is a flatbuffer, little-endian: the file starts with the
root table's offset. A table starts with a signed offset back to its
vtable, which holds its own size, the table's size and one uint16 offset
per field (0: absent). A reference field holds an offset relative to its
own position; a vector is a uint32 count followed by its elements. Field
numbers below are those of TFLite's schema.fbs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# BuiltinOperator codes of the op kinds int8.py runs (schema.fbs).
OP_NAMES = {0: "ADD", 3: "CONV_2D", 4: "DEPTHWISE_CONV_2D", 6: "DEQUANTIZE",
            9: "FULLY_CONNECTED", 14: "LOGISTIC", 18: "MUL", 22: "RESHAPE",
            39: "TRANSPOSE", 40: "MEAN", 42: "DIV", 45: "STRIDED_SLICE",
            82: "REDUCE_MAX", 114: "QUANTIZE"}
# TensorType codes.
DTYPES = {0: np.float32, 2: np.int32, 4: np.int64, 9: np.int8}


class _Table:
    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        size = struct.unpack_from("<H", buf, vt)[0]
        self.slots = struct.unpack_from(f"<{(size - 4) // 2}H", buf, vt + 4)

    def _at(self, i: int) -> int | None:
        if i < len(self.slots) and self.slots[i]:
            return self.pos + self.slots[i]
        return None

    def num(self, i: int, fmt: str, default=0):
        p = self._at(i)
        return default if p is None else struct.unpack_from("<" + fmt, self.buf, p)[0]

    def _ref(self, i: int) -> int | None:
        p = self._at(i)
        return None if p is None else p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, i: int) -> _Table | None:
        p = self._ref(i)
        return None if p is None else _Table(self.buf, p)

    def vector(self, i: int, dtype) -> np.ndarray | None:
        p = self._ref(i)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return np.frombuffer(self.buf, np.dtype(dtype).newbyteorder("<"), n, p + 4).astype(dtype)

    def tables(self, i: int) -> list[_Table]:
        p = self._ref(i)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        slots = [p + 4 + 4 * k for k in range(n)]
        return [_Table(self.buf, s + struct.unpack_from("<I", self.buf, s)[0]) for s in slots]


@dataclass
class Tensor:
    shape: tuple
    dtype: type
    scale: np.ndarray | None       # float32, [1] or one per output channel
    zero_point: np.ndarray | None  # int64
    data: np.ndarray | None        # the constant's contents, else None


@dataclass
class Op:
    kind: str
    inputs: list[int]
    outputs: list[int]
    options: dict = field(default_factory=dict)


@dataclass
class Graph:
    tensors: list[Tensor]
    ops: list[Op]
    inputs: list[int]
    outputs: list[int]


def _options(kind: str, t: _Table | None) -> dict:
    if t is None:
        return {}
    if kind == "CONV_2D":  # padding, stride_w, stride_h, activation, dilation_w, dilation_h
        return {"same": t.num(0, "b") == 0, "stride": (t.num(2, "i"), t.num(1, "i")),
                "dilation": (t.num(5, "i", 1), t.num(4, "i", 1)), "activation": t.num(3, "b")}
    if kind == "DEPTHWISE_CONV_2D":  # ..., depth_multiplier 3, activation 4, dilations 5, 6
        return {"same": t.num(0, "b") == 0, "stride": (t.num(2, "i"), t.num(1, "i")),
                "dilation": (t.num(6, "i", 1), t.num(5, "i", 1)), "activation": t.num(4, "b"),
                "depth_multiplier": t.num(3, "i", 1)}
    if kind == "FULLY_CONNECTED":  # activation, weights_format, keep_num_dims
        return {"activation": t.num(0, "b"), "weights_format": t.num(1, "b"),
                "keep_num_dims": bool(t.num(2, "B"))}
    if kind in ("ADD", "MUL", "DIV"):
        return {"activation": t.num(0, "b")}
    if kind in ("MEAN", "REDUCE_MAX"):
        return {"keep_dims": bool(t.num(0, "B"))}
    if kind == "STRIDED_SLICE":  # begin, end, ellipsis, new_axis, shrink_axis masks
        return {k: t.num(n, "i") for n, k in enumerate(
            ("begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask", "shrink_axis_mask"))}
    return {}


def read(buf: bytes) -> Graph:
    if buf[4:8] != b"TFL3":
        raise ValueError("not a .tflite file")
    model = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    # OperatorCode: deprecated_builtin_code 0 (int8), builtin_code 3 (int32).
    codes = [max(c.num(0, "b"), c.num(3, "i")) for c in model.tables(1)]
    buffers = [b.vector(0, np.uint8) for b in model.tables(4)]
    sub = model.tables(2)[0]
    tensors = []
    for t in sub.tables(0):  # shape 0, type 1, buffer 2, quantization 4
        dims = t.vector(0, np.int32)
        shape = () if dims is None else tuple(int(d) for d in dims)
        dtype = DTYPES[t.num(1, "b")]
        q = t.table(4)  # scale 2, zero_point 3
        scale = None if q is None else q.vector(2, np.float32)
        zp = None if q is None else q.vector(3, np.int64)
        if scale is not None and scale.size == 0:
            scale = zp = None
        raw = buffers[t.num(2, "I")]
        data = (np.frombuffer(raw.tobytes(), dtype).reshape(shape)
                if raw is not None and raw.size else None)
        tensors.append(Tensor(shape, dtype, scale, zp, data))
    ops = []
    for o in sub.tables(3):  # opcode_index 0, inputs 1, outputs 2, builtin_options 4
        code = codes[o.num(0, "I")]
        kind = OP_NAMES.get(code, f"BUILTIN_{code}")
        ops.append(Op(kind, [int(i) for i in o.vector(1, np.int32)],
                      [int(i) for i in o.vector(2, np.int32)], _options(kind, o.table(4))))
    return Graph(tensors, ops, [int(i) for i in sub.vector(1, np.int32)],
                 [int(i) for i in sub.vector(2, np.int32)])
