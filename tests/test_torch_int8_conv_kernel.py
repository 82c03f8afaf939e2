"""The INT8 executor's int8 convolution kernels (ops/csrc/int8_conv_kernel.cu)
against the executor's plain steps, on the card.

Every test needs a CUDA device and skips without one. The file imports no
JAX (tests/conftest.py does, so run it on the card with):

    python -m pytest --noconftest tests/test_torch_int8_conv_kernel.py -m cuda

The kernels' arithmetic is exact integer arithmetic, so every tensor they
compute must equal the plain path's (the CPU executor, which tier-1 holds
bit-equal to the JAX executor) bit for bit: torch.equal, no tolerance.
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
    entry_quant_params,
    kernel_plan,
    layout_plan,
)
from tests.int8_fixture import (
    FLAGSHIP_TFLITE,
    entry_transpose_fixture,
    flagship_features,
    tiny_conv_graph,
)
from tests.int8_op_graphs import _Builder

_RELU, _RELU6 = 1, 3
IN_SCALE = 0.02  # the fuzz graphs' input scale


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 convolution kernels have no CPU mode")


def _all_equal(graph, B, x, **kw):
    """Run the executor with return_all on the card and on the CPU; assert
    every tensor is equal, and return the card's output."""
    got = build_executor(graph, B, device="cuda", return_all=True, **kw)(x.cuda())
    ref = build_executor(graph, B, device="cpu", return_all=True, **kw)(x)
    assert set(got) == set(ref)
    for t, r in ref.items():
        g = got[t]
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(g, r)
        else:
            assert g.dtype == r.dtype and g.shape == r.shape, t
            assert torch.equal(g.cpu(), r), (t, int((g.cpu() != r).sum()))
    out = build_executor(graph, B, device="cuda", **kw)(x.cuda())
    assert torch.equal(out.cpu(), ref[graph.outputs[0]])
    return out


def _flagship(fused: bool, B: int):
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    x = torch.from_numpy(flagship_features(B, seed=B))
    if not fused:
        return graph, x
    graph = entry_transpose_fixture(graph)
    scale, zp = entry_quant_params(graph)
    codes = P.quantize_f32(x[..., 0].transpose(1, 2)[:, None], P.f32_reciprocal(scale, "cpu"),
                           zp)
    return graph, codes.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("requant", ["exact", "fast"])
@pytest.mark.parametrize("fused", [False, True], ids=["float_entry", "int8_entry"])
@pytest.mark.parametrize("B", [1, 3, 64])
def test_flagship_every_tensor_on_card(cuda, B, fused, requant):
    """Every tensor of the flagship graph, kernels on the card against the
    plain path on the CPU, bit for bit; each kernel launches once a call."""
    graph, x = _flagship(fused, B)
    K.launches.clear()
    _all_equal(graph, B, x, requant=requant, prequantized_input=fused)
    # return_all and the plain call: 23 launches each.
    assert K.launches == {K.TAPS_KERNEL: 24, K.POINTWISE_KERNEL: 22}


@pytest.mark.cuda
def test_launch_counter_counts_23_on_one_call(cuda):
    graph, x = _flagship(False, 8)
    f = build_executor(graph, 8, device="cuda")
    assert f.steps == 57 - 7
    K.launches.clear()
    f(x.cuda())
    assert sum(K.launches.values()) == 23
    plan = kernel_plan(graph, layout_plan(graph))
    assert K.launches[K.TAPS_KERNEL] == sum(k == K.TAPS_KERNEL for k in plan.kernel.values())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["float_entry", "int8_entry"])
def test_graph_replay_equals_eager_first_call(cuda, fused):
    """TFLiteSimRunner's CUDA graph: its eager first call, two replays and
    the CPU executor agree bit for bit; the replay runs the kernels."""
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner

    graph, x = _flagship(fused, 64)
    fwd = TFLiteSimRunner(graph, device="cuda").executor(64, prequantized_input=fused)
    first = fwd(x.cuda())
    assert fwd.graph is not None and not fwd.eager_only
    ref = build_executor(graph, 64, device="cpu", prequantized_input=fused)(x)
    for got in (first, fwd(x.cuda()), fwd(x.clone().cuda())):
        assert torch.equal(got.cpu(), ref)


# --- A seeded fuzz of one-op graphs: QUANTIZE -> the op (-> ADD) -> DEQUANTIZE.


def _quantized_input(b: _Builder, shape, zp: int):
    """A float graph input and its QUANTIZE to int8 with zero point zp."""
    x = b.t(shape, "float32")
    q = b.t(shape, scale=IN_SCALE, zp=zp)
    b.op("QUANTIZE", [x], [q])
    return x, q


def _weights(b: _Builder, shape, channels: int, per_channel: bool, qdim: int, big: bool,
             out_scale: float):
    """int8 weights with per-channel or per-tensor scales. `big` gives
    requantization multipliers in [1.1, 3] (a left shift > 0) with small
    weight codes, so that outputs over inputs near the zero point
    (`_inputs(spread=...)`) stay inside the int8 range."""
    n = channels if per_channel else 1
    if big:
        scale = b.rng.uniform(1.1, 3.0, n) * out_scale / IN_SCALE
        data = b.rng.integers(-8, 9, shape)
    else:
        scale = b.rng.uniform(0.0005, 0.004, n)
        data = b.rng.integers(-127, 128, shape)
    return b.t(shape, scale=scale, zp=np.zeros(n), qdim=qdim, data=data.astype(np.int8))


def _inputs(shape, zp: int, seed: int, spread: int | None = None) -> torch.Tensor:
    """Floats whose codes cover [-128, 127], or zp +- spread."""
    rng = np.random.default_rng(seed)
    codes = (rng.integers(-128, 128, shape) if spread is None
             else np.clip(zp + rng.integers(-spread, spread + 1, shape), -128, 127))
    return torch.from_numpy(((codes - zp) * IN_SCALE).astype(np.float32))


# depthwise: (kernel, stride, padding, H, W, C_in, multiplier, dilation)
DEPTHWISE = [(3, 1, "SAME", 9, 7, 16, 1, 1), (3, 2, "SAME", 9, 7, 16, 1, 1),
             (3, 1, "VALID", 9, 7, 32, 1, 1), (3, 2, "VALID", 11, 13, 8, 1, 1),
             (5, 1, "SAME", 9, 7, 16, 1, 1), (5, 2, "SAME", 13, 9, 24, 1, 1),
             (5, 2, "VALID", 13, 9, 4, 1, 1), (3, 1, "SAME", 7, 9, 8, 2, 1),
             (3, 2, "SAME", 9, 9, 3, 2, 1), (3, 1, "SAME", 9, 11, 16, 1, 2),
             (3, 2, "SAME", 7, 5, 256, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEPTHWISE, ids=lambda c: "k{}s{}{}_{}x{}c{}m{}d{}".format(*c))
@pytest.mark.parametrize("requant", ["exact", "fast"])
def test_depthwise_fuzz_on_card(cuda, case, requant):
    k, s, padding, H, W, C, m, d = case
    for seed, (zi, zo, act, per_channel, big) in enumerate(
            [(-128, 127, _RELU6, True, False), (127, -128, 0, False, True),
             (5, -3, _RELU, True, True)]):
        b = _Builder(P, seed=10 * DEPTHWISE.index(case) + seed)
        x, q = _quantized_input(b, (1, H, W, C), zi)
        wt = _weights(b, (1, k, k, C * m), C * m, per_channel, 3, big, 0.05)
        bias = b.const(b.rng.integers(-50, 50, C * m) if big else
                       b.rng.integers(-3000, 3000, C * m))
        Ho = -(-H // s) if padding == "SAME" else (H - (k - 1) * d - 1) // s + 1
        Wo = -(-W // s) if padding == "SAME" else (W - (k - 1) * d - 1) // s + 1
        y = b.t((1, Ho, Wo, C * m), scale=0.05, zp=zo)
        b.op("DEPTHWISE_CONV_2D", [q, wt, bias], [y], padding=padding, strides=(s, s),
             dilation=(d, d), activation=act, depth_multiplier=m)
        graph = b.graph(x, b.exit(y))
        assert kernel_plan(graph, layout_plan(graph)).kernel == {1: K.TAPS_KERNEL}
        _all_equal(graph, 5, _inputs((5, H, W, C), zi, seed, 6 if big else None),
                   requant=requant)


@pytest.mark.cuda
@pytest.mark.parametrize("requant", ["exact", "fast"])
@pytest.mark.parametrize("case", [(3, (1, 2), "SAME", 16, 32, 8), (3, (1, 2), "SAME", 64, 256, 16),
                                  (1, (1, 125), "VALID", 1, 4000, 16),
                                  (3, (2, 2), "VALID", 9, 7, 12)],
                         ids=lambda c: "k{}s{}{}_{}x{}c{}".format(c[0], *c[1], *c[2:]))
def test_one_channel_conv_fuzz_on_card(cuda, case, requant):
    """CONV_2D over one input channel (the flagship's first conv, the raw
    frontend's strided 1 x 16), contiguous and through a transposed view
    (the swapped problem)."""
    k, (sh, sw), padding, H, W, C = case
    kw = 16 if k == 1 else k
    for seed, transposed in enumerate((False, True)):
        b = _Builder(P, seed=17 + seed)
        shape = (1, W, H, 1) if transposed else (1, H, W, 1)
        x, q = _quantized_input(b, shape, -128)
        if transposed:
            t = b.t((1, H, W, 1), scale=0.02, zp=-128)
            b.op("TRANSPOSE", [q, b.const([0, 2, 1, 3])], [t])
            q = t
        wt = _weights(b, (C, k, kw, 1), C, True, 0, False, 0.05)
        bias = b.const(b.rng.integers(-3000, 3000, C))
        Ho = -(-H // sh) if padding == "SAME" else (H - k) // sh + 1
        Wo = -(-W // sw) if padding == "SAME" else (W - kw) // sw + 1
        y = b.t((1, Ho, Wo, C), scale=0.05, zp=-128)
        b.op("CONV_2D", [q, wt, bias], [y], padding=padding, strides=(sh, sw),
             dilation=(1, 1), activation=_RELU6)
        graph = b.graph(x, b.exit(y))
        assert K.TAPS_KERNEL in kernel_plan(graph, layout_plan(graph)).kernel.values()
        _all_equal(graph, 3, _inputs((3, *shape[1:]), -128, seed), requant=requant)


# pointwise: (C_in, C_out, stride, H, W)
POINTWISE = [(16, 32, 1, 9, 7), (32, 32, 1, 8, 8), (64, 128, 1, 5, 3), (128, 256, 1, 4, 8),
             (256, 256, 1, 3, 5), (256, 100, 1, 2, 3), (8, 16, 1, 7, 7), (20, 24, 1, 5, 5),
             (3, 5, 1, 4, 4), (16, 16, 2, 9, 7), (64, 32, 2, 8, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", POINTWISE, ids=lambda c: "i{}o{}s{}_{}x{}".format(*c))
@pytest.mark.parametrize("requant", ["exact", "fast"])
def test_pointwise_fuzz_on_card(cuda, case, requant):
    c_in, c_out, s, H, W = case
    for seed, (zi, zo, act, per_channel, big) in enumerate(
            [(-128, 127, 0, True, False), (127, -128, _RELU6, False, True),
             (9, 2, _RELU, True, True)]):
        b = _Builder(P, seed=10 * POINTWISE.index(case) + seed)
        x, q = _quantized_input(b, (1, H, W, c_in), zi)
        wt = _weights(b, (c_out, 1, 1, c_in), c_out, per_channel, 0, big, 0.05)
        bias = b.const(b.rng.integers(-50, 50, c_out) if big else
                       b.rng.integers(-30000, 30000, c_out))
        y = b.t((1, -(-H // s), -(-W // s), c_out), scale=0.05, zp=zo)
        b.op("CONV_2D", [q, wt, bias], [y], padding="SAME", strides=(s, s), dilation=(1, 1),
             activation=act)
        graph = b.graph(x, b.exit(y))
        assert kernel_plan(graph, layout_plan(graph)).kernel == {1: K.POINTWISE_KERNEL}
        _all_equal(graph, 7, _inputs((7, H, W, c_in), zi, seed, 2 if big else None),
                   requant=requant)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 32, 64, 128, 256, 24])
@pytest.mark.parametrize("conv_first", [True, False])
@pytest.mark.parametrize("requant", ["exact", "fast"])
def test_fused_add_fuzz_on_card(cuda, c, conv_first, requant):
    """A 1x1 CONV_2D (no activation) whose only reader is an ADD with the
    conv's own input: the ADD runs in the kernel's epilogue, and with
    return_all the conv's codes are kept too."""
    for seed, (zi, zo, add_act) in enumerate([(-128, -20, _RELU6), (127, 6, 0), (3, -1, _RELU)]):
        b = _Builder(P, seed=c + seed)
        x, q = _quantized_input(b, (1, 6, 5, c), zi)
        big = seed == 2
        wt = _weights(b, (c, 1, 1, c), c, seed != 1, 0, big, 0.04)
        bias = b.const(b.rng.integers(-50, 50, c) if big else
                       b.rng.integers(-30000, 30000, c))
        y = b.t((1, 6, 5, c), scale=0.04, zp=zo)
        b.op("CONV_2D", [q, wt, bias], [y], padding="SAME", strides=(1, 1), dilation=(1, 1),
             activation=0)
        z = b.t((1, 6, 5, c), scale=0.03, zp=-128 if add_act else 11)
        b.op("ADD", [y, q] if conv_first else [q, y], [z], activation=add_act)
        graph = b.graph(x, b.exit(z))
        assert kernel_plan(graph, layout_plan(graph)).fused_add == {2: 1}
        K.launches.clear()
        _all_equal(graph, 4, _inputs((4, 6, 5, c), zi, seed, 2 if big else None),
                   requant=requant)
        assert K.launches == {K.POINTWISE_KERNEL: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("padding,stride,dilation", [("SAME", (1, 1), (1, 1)),
                                                      ("VALID", (2, 1), (1, 1)),
                                                      ("SAME", (2, 2), (2, 2)),
                                                      ("VALID", (1, 2), (2, 1))])
@pytest.mark.parametrize("requant", ["exact", "fast"])
def test_tiny_conv_graph_on_card(cuda, padding, stride, dilation, requant):
    """tests/int8_fixture.py::tiny_conv_graph: a 3x3 CONV_2D over 3 channels
    (plain, the unfold GEMM), a depth-multiplier-2 depthwise with dilation
    (the taps kernel) and a stride-2 1x1 CONV_2D, 8 -> 5 (the pointwise
    kernel): every tensor bit-equal to the CPU's."""
    graph = tiny_conv_graph(P, padding, stride, dilation, _RELU)
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (4, 9, 7, 3)).astype(np.float32))
    K.launches.clear()
    _all_equal(graph, 4, x, requant=requant)
    assert K.launches == {K.TAPS_KERNEL: 2, K.POINTWISE_KERNEL: 2}
