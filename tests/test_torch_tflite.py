"""PyTorch port, INT8 leg: the TFLite reader and the integer executor.

Each is held against the JAX package on the same numpy inputs, on the
committed flagship graph (artifacts/flagship/bundle/model_quantized.tflite),
and the executor also against the TFLite interpreter. Tolerance: none. The
executor is integer arithmetic plus a few float32 steps that repeat the
jitted JAX ones operation for operation, so its scores must be BIT-equal
to the jitted JAX executor's, which are bit-equal to the interpreter's
(invoked one sample at a time: the graph's RESHAPE carries a literal batch
1, so the interpreter cannot resize the batch).
"""

import copy
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.quant import tflite_import as J
from birdnet_stm32_tpu_torch.quant import tflite_import as P
from tests.int8_fixture import (
    FLAGSHIP_TFLITE,
    flagship_features,
    tie_features,
    tiny_conv_graph,
)
from tests.test_torch_cpu_warmup import warm_up

warm_up()

GOLDEN = Path(__file__).resolve().parent / "goldens" / "torch_int8_flagship_scores.npz"
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _graphs():
    return P.TFLiteGraph(FLAGSHIP_TFLITE), J.TFLiteGraph(str(FLAGSHIP_TFLITE))


@functools.lru_cache(maxsize=None)
def _jax_executor(B: int):
    return jax.jit(J.build_executor(_graphs()[1], B))


def _features(kind: str, B: int) -> np.ndarray:
    if kind == "uniform":
        return flagship_features(B)
    if kind == "fourth_power":
        return flagship_features(B) ** 4
    graph = _graphs()[0]
    return tie_features(B, float(graph.tensors[graph.ops[0].outputs[0]].scale[0]))


def _interpreter_scores(x: np.ndarray) -> np.ndarray:
    tf = pytest.importorskip("tensorflow")
    interp = tf.lite.Interpreter(
        model_path=str(FLAGSHIP_TFLITE),
        experimental_op_resolver_type=tf.lite.experimental.OpResolverType
        .BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    inp, out = interp.get_input_details()[0], interp.get_output_details()[0]
    rows = []
    for i in range(x.shape[0]):
        interp.set_tensor(inp["index"], x[i: i + 1])
        interp.invoke()
        rows.append(interp.get_tensor(out["index"]).copy())
    return np.concatenate(rows)


def test_reader_matches_jax():
    """Every tensor (shape, dtype, scales, zero points, quantized dimension,
    buffer), every op (name, inputs, outputs, options) and the graph's
    inputs and outputs, as the JAX reader (TensorFlow's schema) gives them."""
    port, ref = _graphs()
    assert len(port.tensors) == len(ref.tensors) == 124
    for a, b in zip(port.tensors, ref.tensors):
        assert (a.index, a.shape, a.dtype, a.quantized_dimension) == (
            b.index, b.shape, b.dtype, b.quantized_dimension)
        for name in ("scale", "zero_point", "data"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), (a.index, name)
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, (a.index, name)
                np.testing.assert_array_equal(x, y)
    assert [(o.name, o.inputs, o.outputs, o.options) for o in port.ops] == [
        (o.name, o.inputs, o.outputs, o.options) for o in ref.ops]
    assert (port.inputs, port.outputs) == (ref.inputs, ref.outputs) == ([0], [123])
    assert len(port.ops) == 57


def test_reader_rejects_other_files():
    with pytest.raises(ValueError, match="TFL3"):
        P.TFLiteGraph(b"\x00" * 64)


def test_quantize_multiplier_matches_jax():
    """Random multipliers over 40 octaves, plus exact mantissa ties
    ((2n + 1) / 2^32 * 2^e), which half-away rounding must send up."""
    rng = np.random.default_rng(0)
    ms = list(np.exp2(rng.uniform(-35, 5, 2000)))
    n = rng.integers(1 << 30, 1 << 31, 200)
    ms += [float((2 * k + 1) * 2.0**-32 * 2.0**e) for k, e in zip(n, rng.integers(-20, 3, 200))]
    ms += [0.0, 1.0, 0.5, 2.0**-31, 2.0**-40]
    for m in ms:
        assert P._quantize_multiplier(float(m)) == J._quantize_multiplier(float(m)), m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mbqm_matches_jax(seed):
    """int64 MBQM (per tensor and per channel) vs the JAX host golden and its
    jitted 16-bit-limb form, on accumulators from small to 2^30 and on the
    rounding ties that multiplier 0.5 (qm = 2^30) produces at every shift."""
    rng = np.random.default_rng(seed)
    mults = np.exp2(rng.uniform(-20, 0.5, 8))
    qs = [J._quantize_multiplier(float(m)) for m in mults] + [(1 << 30, s) for s in (0, -1, -3, -9)]
    for qm, shift in qs:
        lim = (1 << 30) >> max(shift, 0)
        x = np.concatenate([rng.integers(-lim, lim, 3000), rng.integers(-600, 600, 1200),
                            np.arange(-64, 64)]).astype(np.int32)
        ref = J._mbqm_host_vec(x, qm, shift)
        np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: J._mbqm(v, qm, shift))(x)), ref)
        got = P._mbqm_fn(qm, shift, CPU)(torch.from_numpy(x.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), ref)
    # Per channel: [N, C] accumulators, one (qm, shift) per channel.
    qm_c = np.array([q for q, _ in qs], np.int64)
    sh_c = np.array([s for _, s in qs], np.int64)
    x = rng.integers(-(1 << 24), 1 << 24, (500, len(qs)))
    ref = J._mbqm_host_vec(x, qm_c, sh_c)
    got = P._mbqm_fn(qm_c, sh_c, CPU)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["uniform", "fourth_power", "ties"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_executor_bit_equal_to_jax(B, kind):
    """The port's executor on the CPU vs the jitted JAX executor, flagship
    graph: seeded uniform features, their 4th powers (most codes near the
    zero point), and features on and one ulp beside the entry quantize's
    rounding ties."""
    x = _features(kind, B)
    ref = np.asarray(_jax_executor(B)(jnp.asarray(x)))
    got = P.build_executor(_graphs()[0], B, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (B, 100) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_executor_bit_equal_to_interpreter():
    """4 rows through the TFLite interpreter, one sample at a time."""
    x = flagship_features(4, seed=5)
    ref = _interpreter_scores(x)
    got = P.build_executor(_graphs()[0], 4, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_golden_regenerates():
    """tests/goldens/torch_int8_flagship_scores.npz is the jitted JAX
    executor's scores on flagship_features(8), and the port's."""
    golden = np.load(GOLDEN)["scores"]
    x = flagship_features(8)
    np.testing.assert_array_equal(np.asarray(_jax_executor(8)(jnp.asarray(x))), golden)
    got = P.build_executor(_graphs()[0], 8, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, golden)


def test_golden_matches_interpreter():
    np.testing.assert_array_equal(_interpreter_scores(flagship_features(8)),
                                  np.load(GOLDEN)["scores"])


def test_interpreter_entry_rounds_half_to_even():
    """A property of the reference, kept: TFLite's QUANTIZE rounds exact
    ties half to even, the executors (JAX and port) half away from zero.
    On the golden's 8 rows the entry codes differ only at exact ties (4 of
    526,336 codes), and the scores are equal all the same."""
    tf = pytest.importorskip("tensorflow")
    graph = _graphs()[0]
    entry = graph.ops[0].outputs[0]
    x = flagship_features(8)
    interp = tf.lite.Interpreter(
        model_path=str(FLAGSHIP_TFLITE), experimental_preserve_all_tensors=True,
        experimental_op_resolver_type=tf.lite.experimental.OpResolverType
        .BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    codes = []
    for i in range(8):
        interp.set_tensor(interp.get_input_details()[0]["index"], x[i: i + 1])
        interp.invoke()
        codes.append(interp.get_tensor(entry).copy())
    codes = np.concatenate(codes)
    ours = P.build_executor(graph, 8, device="cpu", return_all=True)(torch.from_numpy(x))
    ours = ours[entry].numpy()
    where = np.nonzero(codes != ours)
    f = x[where] * (np.float32(1) / np.float32(graph.tensors[entry].scale[0]))
    assert len(where[0]) == 4
    np.testing.assert_array_equal(f % 1, 0.5)  # exact ties only
    zp = int(graph.tensors[entry].zero_point[0])
    np.testing.assert_array_equal(ours[where], np.floor(f + 0.5) + zp)  # half away (f > 0)
    np.testing.assert_array_equal(codes[where], np.round(f) + zp)  # half to even


@pytest.mark.parametrize("padding,stride,dilation,act", [
    ("SAME", (2, 2), (1, 1), 1), ("VALID", (1, 2), (1, 1), 3), ("SAME", (1, 1), (2, 2), 0)])
def test_general_convolutions_bit_equal_to_jax(padding, stride, dilation, act):
    """Paths the flagship graph does not take: a 3x3 CONV_2D over 3 input
    channels (unfold + GEMM), a depthwise conv with depth_multiplier 2 and a
    strided 1x1 CONV_2D, with SAME / VALID padding, strides and dilation."""
    B = 3
    x = np.random.default_rng(7).uniform(-1, 1, (B, 9, 7, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(J.build_executor(
        tiny_conv_graph(J, padding, stride, dilation, act), B))(jnp.asarray(x)))
    got = P.build_executor(tiny_conv_graph(P, padding, stride, dilation, act), B,
                           device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_executor_rejects_what_it_cannot_run():
    """An op neither executor runs raises NotImplementedError; so does an
    invalid requant mode (ValueError), a prequantized entry the graph does
    not have, and an input of the wrong batch."""
    graph = _graphs()[0]
    with pytest.raises(ValueError, match="requant"):
        P.build_executor(graph, 1, device="cpu", requant="approximate")
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner

    with pytest.raises(ValueError, match="requant"):
        TFLiteSimRunner(graph, device="cpu", requant="approximate")
    other = copy.copy(graph)
    other.ops = list(graph.ops)
    other.ops[55] = P.OpInfo("GATHER", graph.ops[55].inputs, graph.ops[55].outputs, {})
    with pytest.raises(NotImplementedError, match="GATHER"):
        P.build_executor(other, 1, device="cpu")
    j_other = copy.copy(_graphs()[1])
    j_other.ops = list(j_other.ops)
    j_other.ops[55] = J.OpInfo("GATHER", j_other.ops[55].inputs, j_other.ops[55].outputs, {})
    with pytest.raises(NotImplementedError, match="GATHER"):
        J.build_executor(j_other, 1)(jnp.zeros((1, 257, 256, 1), jnp.float32))
    with pytest.raises(ValueError, match="QUANTIZE -> TRANSPOSE"):
        P.build_executor(graph, 1, device="cpu", prequantized_input=True)
    fwd = P.build_executor(graph, 2, device="cpu")
    with pytest.raises(ValueError, match="executor for 2"):
        fwd(torch.zeros(3, 257, 256, 1))
