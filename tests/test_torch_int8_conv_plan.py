"""The INT8 executor's plan for its int8 convolution kernels, on the CPU.

On a CUDA device `build_executor` runs the convolutions of `kernel_plan`
as the hand-written kernels of ops/kernels/int8_conv_kernel.py, each fused
ADD in its convolution's epilogue; the CPU runs every op plain and never
loads the kernels' library. The kernels themselves run only on the card
(tests/test_torch_int8_conv_kernel.py); here: which ops they serve, that
the ops outside their class stay plain, the weights' layout the kernels
read, and the fused step's plain branch, which torch.export traces.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.ops.kernels import int8_conv_kernel as K
from birdnet_stm32_tpu_torch.quant import tflite_import as P
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    TFLiteGraph,
    build_executor,
    kernel_plan,
    layout_plan,
)
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, tiny_conv_graph
from tests.int8_op_graphs import _Builder, op_graph, op_inputs

# The flagship's residual ADDs and the 1x1 CONV_2D each one reads.
FLAGSHIP_FUSED = {28: 27, 33: 32, 36: 35, 41: 40, 44: 43, 47: 46, 52: 51}


@pytest.mark.parametrize("entry", ["float", "int8"])
def test_flagship_plan(entry):
    """Every body convolution is served, 12 CONV_2D + 11 DEPTHWISE_CONV_2D
    (op 23 and the depthwise ones by the taps kernel, the other 11 CONV_2D
    by the pointwise kernel), and the 7 residual ADDs fuse."""
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    target = None
    if entry == "int8":
        graph = entry_transpose_fixture(graph)
        target = graph.ops[1].outputs[0]
    plan = kernel_plan(graph, layout_plan(graph, target))
    convs = [i for i, op in enumerate(graph.ops) if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D")]
    assert sorted(plan.kernel) == convs and len(convs) == 23 and convs[::22] == [23, 51]
    names = [graph.ops[i].name for i in convs]
    assert names.count("CONV_2D") == 12 and names.count("DEPTHWISE_CONV_2D") == 11
    taps = sorted(i for i, k in plan.kernel.items() if k == K.TAPS_KERNEL)
    assert taps == [23] + [i for i in convs if graph.ops[i].name == "DEPTHWISE_CONV_2D"]
    assert sum(k == K.POINTWISE_KERNEL for k in plan.kernel.values()) == 11
    assert plan.fused_add == FLAGSHIP_FUSED
    assert all(graph.ops[i].name == "ADD" for i in plan.fused_add)


def test_ops_outside_the_class_stay_plain():
    """A kxk CONV_2D over more than one channel, the per-channel-affine 1x1
    depthwise and a 1x1 CONV_2D over more than 256 channels take no
    kernel; neither a SUB nor an ADD of a conv that another op reads too
    fuses."""
    tiny = tiny_conv_graph(P, "SAME", (1, 1), (1, 1), 1)
    plan = kernel_plan(tiny, layout_plan(tiny))
    assert tiny.ops[1].name == "CONV_2D" and 1 not in plan.kernel  # 3x3 over 3 channels
    assert plan.kernel == {2: K.TAPS_KERNEL, 3: K.POINTWISE_KERNEL}
    affine = op_graph(P, "depthwise_1x1")
    assert kernel_plan(affine, layout_plan(affine)).kernel == {}

    def conv_then(op_name, c=8, read_twice=False):
        b = _Builder(P, seed=c)
        x = b.t((1, 4, 4, c), "float32")
        q = b.t((1, 4, 4, c), scale=0.02, zp=-3)
        b.op("QUANTIZE", [x], [q])
        w = b.t((c, 1, 1, c), scale=np.full(c, 0.003), zp=np.zeros(c),
                data=b.rng.integers(-127, 128, (c, 1, 1, c)).astype(np.int8))
        y = b.t((1, 4, 4, c), scale=0.04, zp=1)
        b.op("CONV_2D", [q, w, b.const(np.zeros(c))], [y], padding="SAME", strides=(1, 1),
             dilation=(1, 1), activation=0)
        z = b.t((1, 4, 4, c), scale=0.05, zp=2)
        b.op(op_name, [y, q], [z], activation=0)
        if read_twice:
            z2 = b.t((1, 4, 4, c), scale=0.05, zp=2)
            b.op("ADD", [z, y], [z2], activation=0)
            z = z2
        g = b.graph(x, b.exit(z))
        return kernel_plan(g, layout_plan(g))

    assert conv_then("ADD").fused_add == {2: 1}
    assert conv_then("SUB").fused_add == {}
    assert conv_then("ADD", read_twice=True).fused_add == {}
    wide = conv_then("ADD", c=K.MAX_POINTWISE_IN + 8)
    assert wide.kernel == {} and wide.fused_add == {}


def test_cpu_executor_never_loads_the_library(monkeypatch):
    """CPU executors of graphs full of served convolutions run without the
    kernels' library: its loader is never called."""
    def refuse():
        raise AssertionError("a CPU executor loaded the int8 convolution library")
    monkeypatch.setattr(K, "library", refuse)
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 257, 256, 1)))
    assert build_executor(graph, 1, device="cpu")(x.float()).shape == (1, 100)
    tiny = tiny_conv_graph(P, "VALID", (2, 1), (1, 1), 3)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 9, 7, 3)).astype(np.float32))
    assert build_executor(tiny, 2, device="cpu", requant="fast")(x).dtype == torch.float32


@pytest.mark.parametrize("c_out,c_in", [(32, 16), (256, 256), (100, 256), (5, 3), (24, 20)])
def test_pointwise_weight_words(c_out, c_in):
    """The packed words hold weight (n, k) in byte k % 4 of word
    (k // 4, n), zero past C_in and C_out; a block's channel tile divides
    the padded channels."""
    w = np.random.default_rng(c_out).integers(-128, 128, (c_out, c_in)).astype(np.int8)
    pw = K.pointwise_weights(w, torch.device("cpu"))
    k_words, npad = pw.words.shape
    assert k_words * 4 == -(-c_in // 16) * 16 and npad % pw.tn == 0 and pw.tn % 8 == 0
    assert pw.tn <= 64 and npad - c_out < pw.tn
    unpacked = pw.words.numpy().view(np.int8).reshape(k_words, npad, 4).transpose(1, 0, 2)
    unpacked = unpacked.reshape(npad, 4 * k_words)
    np.testing.assert_array_equal(unpacked[:c_out, :c_in], w)
    assert not unpacked[c_out:].any() and not unpacked[:, c_in:].any()
    with pytest.raises(ValueError, match="input channels"):
        K.pointwise_weights(np.zeros((4, K.MAX_POINTWISE_IN + 1), np.int8), torch.device("cpu"))


def test_epilogue_and_taps_layout():
    """Per-tensor constants broadcast to every channel; tap (p, q) is row
    p * kw + q of the taps."""
    ep = K.epilogue(np.arange(6), 1234, [-3], np.float32(0.25), 5, -128, 127, True, 6,
                    torch.device("cpu"))
    assert ep.correction.tolist() == list(range(6)) and ep.qm.tolist() == [1234] * 6
    assert ep.shift.dtype == torch.int32 and ep.shift.tolist() == [-3] * 6
    assert ep.mult.tolist() == [0.25] * 6 and ep.fast and (ep.zp, ep.lo, ep.hi) == (5, -128, 127)
    w = np.arange(2 * 3 * 4, dtype=np.int8).reshape(2, 3, 4)
    taps = K.taps_weights(w, torch.device("cpu"))
    assert (taps.kh, taps.kw) == (2, 3)
    np.testing.assert_array_equal(taps.taps.numpy()[1 * 3 + 2], w[1, 2])


@pytest.mark.parametrize("return_all", [False, True])
def test_fused_step_is_plain_while_exporting(monkeypatch, return_all):
    """The fused CONV_2D + ADD step takes its plain branch while torch.export
    traces (here forced, on the CPU): the conv and then the ADD, every
    tensor as the unfused executor computes it."""
    b = _Builder(P, seed=5)
    x = b.t((1, 6, 5, 4), "float32")
    q = b.t((1, 6, 5, 4), scale=2.0 / 255, zp=-3)
    b.op("QUANTIZE", [x], [q])
    w = b.t((4, 1, 1, 4), scale=np.full(4, 0.004), zp=np.zeros(4),
            data=b.rng.integers(-127, 128, (4, 1, 1, 4)).astype(np.int8))
    y = b.t((1, 6, 5, 4), scale=0.03, zp=-7)
    b.op("CONV_2D", [q, w, b.const(b.rng.integers(-900, 900, 4))], [y], padding="SAME",
         strides=(1, 1), dilation=(1, 1), activation=0)
    z = b.t((1, 6, 5, 4), scale=0.04, zp=-128)
    b.op("ADD", [q, y], [z], activation=3)
    graph = b.graph(x, b.exit(z))
    plan = layout_plan(graph)
    assert kernel_plan(graph, plan).fused_add == {2: 1}
    ref = build_executor(graph, 5, device="cpu", return_all=True)(torch.from_numpy(op_inputs(5)))
    build = P._Build(graph, torch.device("cpu"), "exact", plan, {y: K.POINTWISE_KERNEL},
                     return_all)
    step = P._op_conv(build, graph.ops[1], add=graph.ops[2])
    vals = {q: ref[q]}
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    step(vals)
    assert torch.equal(vals[z], ref[z]) and torch.equal(vals[y], ref[y])
