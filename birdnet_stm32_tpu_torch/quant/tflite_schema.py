"""Reader for the subset of the TFLite flatbuffer schema the INT8 executor reads.

A pure Python reader (struct and numpy): neither TensorFlow nor the
`flatbuffers` package is needed. It reads the first subgraph of a `Model`:
its `Tensor`s (shape, type, buffer, quantization scale / zero_point /
quantized_dimension), the `Buffer` contents, the `Operator`s with their
`OperatorCode` and the builtin options tables of the ops the executor knows.

Field ids are the TFLite schema's (tensorflow/compiler/mlir/lite/schema/
schema.fbs): a table field with id i sits at vtable slot 4 + 2 * i.

Flatbuffer layout, all little-endian: the file starts with the root table's
uoffset. A table starts with an soffset back to its vtable (uint16 vtable
size, uint16 table size, one uint16 field offset per field, 0 = absent). An
offset field holds a uoffset relative to its own position; a vector is a
uint32 length followed by its elements (tables as uoffsets, each relative
to its own slot).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

FILE_IDENTIFIER = b"TFL3"

# BuiltinOperator, in enum order (the index is the op code).
BUILTIN_OPERATORS = tuple("""
ADD AVERAGE_POOL_2D CONCATENATION CONV_2D DEPTHWISE_CONV_2D DEPTH_TO_SPACE
DEQUANTIZE EMBEDDING_LOOKUP FLOOR FULLY_CONNECTED HASHTABLE_LOOKUP
L2_NORMALIZATION L2_POOL_2D LOCAL_RESPONSE_NORMALIZATION LOGISTIC
LSH_PROJECTION LSTM MAX_POOL_2D MUL RELU RELU_N1_TO_1 RELU6 RESHAPE
RESIZE_BILINEAR RNN SOFTMAX SPACE_TO_DEPTH SVDF TANH CONCAT_EMBEDDINGS
SKIP_GRAM CALL CUSTOM EMBEDDING_LOOKUP_SPARSE PAD UNIDIRECTIONAL_SEQUENCE_RNN
GATHER BATCH_TO_SPACE_ND SPACE_TO_BATCH_ND TRANSPOSE MEAN SUB DIV SQUEEZE
UNIDIRECTIONAL_SEQUENCE_LSTM STRIDED_SLICE BIDIRECTIONAL_SEQUENCE_RNN EXP
TOPK_V2 SPLIT LOG_SOFTMAX DELEGATE BIDIRECTIONAL_SEQUENCE_LSTM CAST PRELU
MAXIMUM ARG_MAX MINIMUM LESS NEG PADV2 GREATER GREATER_EQUAL LESS_EQUAL SELECT
SLICE SIN TRANSPOSE_CONV SPARSE_TO_DENSE TILE EXPAND_DIMS EQUAL NOT_EQUAL LOG
SUM SQRT RSQRT SHAPE POW ARG_MIN FAKE_QUANT REDUCE_PROD REDUCE_MAX PACK
LOGICAL_OR ONE_HOT LOGICAL_AND LOGICAL_NOT UNPACK REDUCE_MIN FLOOR_DIV
REDUCE_ANY SQUARE ZEROS_LIKE FILL FLOOR_MOD RANGE RESIZE_NEAREST_NEIGHBOR
LEAKY_RELU SQUARED_DIFFERENCE MIRROR_PAD ABS SPLIT_V UNIQUE CEIL REVERSE_V2
ADD_N GATHER_ND COS WHERE RANK ELU REVERSE_SEQUENCE MATRIX_DIAG QUANTIZE
MATRIX_SET_DIAG ROUND HARD_SWISH IF WHILE NON_MAX_SUPPRESSION_V4
NON_MAX_SUPPRESSION_V5 SCATTER_ND SELECT_V2 DENSIFY SEGMENT_SUM BATCH_MATMUL
PLACEHOLDER_FOR_GREATER_OP_CODES CUMSUM CALL_ONCE BROADCAST_TO RFFT2D CONV_3D
IMAG REAL COMPLEX_ABS HASHTABLE HASHTABLE_FIND HASHTABLE_IMPORT HASHTABLE_SIZE
REDUCE_ALL CONV_3D_TRANSPOSE VAR_HANDLE READ_VARIABLE ASSIGN_VARIABLE
BROADCAST_ARGS RANDOM_STANDARD_NORMAL BUCKETIZE RANDOM_UNIFORM MULTINOMIAL
GELU DYNAMIC_UPDATE_SLICE RELU_0_TO_1 UNSORTED_SEGMENT_PROD
UNSORTED_SEGMENT_MAX UNSORTED_SEGMENT_SUM ATAN2 UNSORTED_SEGMENT_MIN SIGN
BITCAST BITWISE_XOR RIGHT_SHIFT STABLEHLO_LOGISTIC STABLEHLO_ADD
STABLEHLO_DIVIDE STABLEHLO_MULTIPLY STABLEHLO_MAXIMUM STABLEHLO_RESHAPE
STABLEHLO_CLAMP STABLEHLO_CONCATENATE STABLEHLO_BROADCAST_IN_DIM
STABLEHLO_CONVOLUTION STABLEHLO_SLICE STABLEHLO_CUSTOM_CALL STABLEHLO_REDUCE
STABLEHLO_ABS STABLEHLO_AND STABLEHLO_COSINE STABLEHLO_EXPONENTIAL
STABLEHLO_FLOOR STABLEHLO_LOG STABLEHLO_MINIMUM STABLEHLO_NEGATE STABLEHLO_OR
STABLEHLO_POWER STABLEHLO_REMAINDER STABLEHLO_RSQRT STABLEHLO_SELECT
STABLEHLO_SUBTRACT STABLEHLO_TANH STABLEHLO_SCATTER STABLEHLO_COMPARE
STABLEHLO_CONVERT STABLEHLO_DYNAMIC_SLICE STABLEHLO_DYNAMIC_UPDATE_SLICE
STABLEHLO_PAD STABLEHLO_IOTA STABLEHLO_DOT_GENERAL STABLEHLO_REDUCE_WINDOW
STABLEHLO_SORT STABLEHLO_WHILE STABLEHLO_GATHER STABLEHLO_TRANSPOSE DILATE
STABLEHLO_RNG_BIT_GENERATOR REDUCE_WINDOW STABLEHLO_COMPOSITE
STABLEHLO_SHIFT_LEFT STABLEHLO_CBRT STABLEHLO_CASE
""".split())

# TensorType codes.
FLOAT32, INT32, UINT8, INT64, BOOL, INT16, INT8 = 0, 2, 3, 4, 6, 7, 9
# Padding codes.
PADDING_SAME = 0


class Table:
    """One flatbuffer table: typed reads of its fields by schema field id."""

    __slots__ = ("buf", "pos", "_vtable", "_vtable_size")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self._vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self._vtable_size = struct.unpack_from("<H", buf, self._vtable)[0]

    def _offset(self, field_id: int) -> int:
        """The field's offset in the table, 0 when the field is absent."""
        slot = 4 + 2 * field_id
        if slot >= self._vtable_size:
            return 0
        return struct.unpack_from("<H", self.buf, self._vtable + slot)[0]

    def _target(self, field_id: int) -> int | None:
        """Position of the object an offset field points to, or None."""
        off = self._offset(field_id)
        if not off:
            return None
        p = self.pos + off
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def scalar(self, field_id: int, fmt: str, default=0):
        """A scalar field of struct format `fmt` (e.g. 'i', 'B', 'f')."""
        off = self._offset(field_id)
        if not off:
            return default
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0]

    def table(self, field_id: int) -> Table | None:
        p = self._target(field_id)
        return None if p is None else Table(self.buf, p)

    def vector(self, field_id: int, dtype) -> np.ndarray | None:
        """A vector of scalars as a numpy array (a copy), or None."""
        p = self._target(field_id)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        dt = np.dtype(dtype).newbyteorder("<")
        return np.frombuffer(self.buf, dtype=dt, count=n, offset=p + 4).astype(dtype)

    def tables(self, field_id: int) -> list[Table]:
        """A vector of tables."""
        p = self._target(field_id)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        out = []
        for i in range(n):
            slot = p + 4 + 4 * i
            out.append(Table(self.buf, slot + struct.unpack_from("<I", self.buf, slot)[0]))
        return out


@dataclass
class Quantization:
    scale: np.ndarray | None         # float32, [1] or [C]
    zero_point: np.ndarray | None    # int64
    quantized_dimension: int


@dataclass
class Tensor:
    shape: np.ndarray | None  # int32
    type: int                 # TensorType code
    buffer: int
    quantization: Quantization | None


@dataclass
class Operator:
    builtin_code: int       # max(builtin_code, deprecated_builtin_code)
    inputs: np.ndarray      # int32, -1 = absent optional input
    outputs: np.ndarray
    options: Table | None   # the builtin options table


@dataclass
class Model:
    tensors: list[Tensor]
    operators: list[Operator]
    inputs: np.ndarray
    outputs: np.ndarray
    buffers: list[np.ndarray | None]  # uint8 contents (None = empty)


def _quantization(t: Table | None) -> Quantization | None:
    # QuantizationParameters: min 0, max 1, scale 2, zero_point 3,
    # details_type 4, details 5, quantized_dimension 6.
    if t is None:
        return None
    return Quantization(t.vector(2, np.float32), t.vector(3, np.int64), t.scalar(6, "i"))


def read_model(buf: bytes) -> Model:
    """Parse a .tflite flatbuffer's first subgraph."""
    if len(buf) < 8 or buf[4:8] != FILE_IDENTIFIER:
        raise ValueError("not a TFLite flatbuffer (no 'TFL3' file identifier)")
    # Model: version 0, operator_codes 1, subgraphs 2, description 3, buffers 4.
    model = Table(buf, struct.unpack_from("<I", buf, 0)[0])
    codes = []
    for oc in model.tables(1):
        # OperatorCode: deprecated_builtin_code 0 (int8), custom_code 1,
        # version 2, builtin_code 3 (int32). Pre-TF-2.3 writers fill only
        # the deprecated field; TFLite resolves with the max of both.
        codes.append(max(oc.scalar(0, "b"), oc.scalar(3, "i")))
    # Buffer: data 0 (ubyte vector), offset 1, size 2.
    buffers = [b.vector(0, np.uint8) for b in model.tables(4)]
    subgraphs = model.tables(2)
    if not subgraphs:
        raise ValueError("TFLite model has no subgraph")
    # SubGraph: tensors 0, inputs 1, outputs 2, operators 3, name 4.
    sg = subgraphs[0]
    tensors = []
    for t in sg.tables(0):
        # Tensor: shape 0, type 1 (int8 enum), buffer 2 (uint32), name 3,
        # quantization 4.
        tensors.append(Tensor(t.vector(0, np.int32), t.scalar(1, "b"), t.scalar(2, "I"),
                              _quantization(t.table(4))))
    operators = []
    for op in sg.tables(3):
        # Operator: opcode_index 0 (uint32), inputs 1, outputs 2,
        # builtin_options_type 3, builtin_options 4.
        operators.append(Operator(codes[op.scalar(0, "I")],
                                  op.vector(1, np.int32), op.vector(2, np.int32),
                                  op.table(4)))
    empty = np.zeros(0, np.int32)
    return Model(tensors, operators, _or(sg.vector(1, np.int32), empty),
                 _or(sg.vector(2, np.int32), empty), buffers)


def _or(v, default):
    return default if v is None else v


def _padding(code: int) -> str:
    return "SAME" if code == PADDING_SAME else "VALID"


def builtin_options(name: str, t: Table | None) -> dict:
    """Decode the builtin options table of the op kinds the executor knows
    (the same keys as the JAX package's reader); {} for any other."""
    if t is None:
        return {}
    if name == "CONV_2D":
        # padding 0, stride_w 1, stride_h 2, fused_activation_function 3,
        # dilation_w_factor 4, dilation_h_factor 5.
        return {"strides": (t.scalar(2, "i"), t.scalar(1, "i")),
                "padding": _padding(t.scalar(0, "b")),
                "dilation": (t.scalar(5, "i", 1), t.scalar(4, "i", 1)),
                "activation": t.scalar(3, "b")}
    if name == "DEPTHWISE_CONV_2D":
        # padding 0, stride_w 1, stride_h 2, depth_multiplier 3,
        # fused_activation_function 4, dilation_w_factor 5, dilation_h_factor 6.
        return {"strides": (t.scalar(2, "i"), t.scalar(1, "i")),
                "padding": _padding(t.scalar(0, "b")),
                "dilation": (t.scalar(6, "i", 1), t.scalar(5, "i", 1)),
                "activation": t.scalar(4, "b"),
                "depth_multiplier": t.scalar(3, "i")}
    if name in ("ADD", "SUB", "MUL", "DIV"):
        return {"activation": t.scalar(0, "b")}  # fused_activation_function 0
    if name == "FULLY_CONNECTED":
        # fused_activation_function 0, weights_format 1, keep_num_dims 2.
        return {"activation": t.scalar(0, "b"), "weights_format": t.scalar(1, "b"),
                "keep_num_dims": bool(t.scalar(2, "B"))}
    if name == "SOFTMAX":
        return {"beta": float(t.scalar(0, "f", 0.0))}  # beta 0
    if name == "CONCATENATION":
        return {"axis": t.scalar(0, "i"), "activation": t.scalar(1, "b")}
    if name in ("MEAN", "REDUCE_MAX", "SUM"):
        return {"keepdims": bool(t.scalar(0, "B"))}  # keep_dims 0
    if name == "RESHAPE":
        shape = t.vector(0, np.int32)  # new_shape 0
        return {"new_shape": [] if shape is None else [int(d) for d in shape]}
    if name == "STRIDED_SLICE":
        # begin_mask 0, end_mask 1, ellipsis_mask 2, new_axis_mask 3,
        # shrink_axis_mask 4.
        return {"begin_mask": t.scalar(0, "i"), "end_mask": t.scalar(1, "i"),
                "ellipsis_mask": t.scalar(2, "i"), "new_axis_mask": t.scalar(3, "i"),
                "shrink_axis_mask": t.scalar(4, "i")}
    if name == "PACK":
        return {"axis": t.scalar(1, "i"), "count": t.scalar(0, "i")}  # values_count 0, axis 1
    return {}
