"""PyTorch port, the runners' CUDA graphs: which call TFLiteSimRunner and
TorchRunner keep, and on a card that the graph's replay is the eager call.

INT8: on a CUDA device the runner replays its executor as one CUDA graph
per (batch size, entry form, card) (models/runners.py::_GraphedCall;
held on the card by tests/test_torch_cuda.py). On the CPU it keeps
build_executor's eager executor itself: the same function object for a
key across calls, the same scores bit for bit as a fresh build_executor,
and the same computed steps: 57 on the flagship graph's own entry (the
entry the benchmark's INT8 cell serves), 55 on the fused entry of its
entry-transpose fixture, whose QUANTIZE and TRANSPOSE the frontend
kernel's int8 epilogue takes over.

Float: TorchRunner replays each row block's eval forward as one CUDA graph
per (batch size, input dtype, card) (models/runners.py::_GraphedCall). It
stays eager on the CPU, under the activation fake-quant hook, and for a
model whose layers open spans of their own (EfficientNet-B1's MBConv
blocks, models/blocks.py::opens_spans); the CPU tests hold that rule. The
card tests (marked cuda; they skip without a card and import no JAX, so
run them there with `python -m pytest --noconftest
tests/test_torch_runner_graph.py -m cuda`) hold the replay bit-equal to
the eager forward on the same card at 64 flagship rows, in float32 and
bf16, and its answers, input checks, fallback, span and mesh.
"""

import contextlib
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.blocks import opens_spans
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
from birdnet_stm32_tpu_torch.models.efficientnet import build_efficientnet
from birdnet_stm32_tpu_torch.models.runners import (
    TFLiteSimRunner,
    TorchRunner,
    _GraphedCall,
)
from birdnet_stm32_tpu_torch.parallel.steps import infer_block
from birdnet_stm32_tpu_torch.quant.fake_quant import activation_fake_quant
from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
from birdnet_stm32_tpu_torch.utils.tracing import MBCONV_DW, TORCH_GRAPH
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, flagship_features
from tests.test_torch_cuda import _kernels_and_spans

B = 2


def _graph_and_input(fused: bool):
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    if not fused:
        return graph, torch.from_numpy(flagship_features(B, seed=3))
    codes = np.random.default_rng(3).integers(-128, 128, (B, 1, 256, 257))
    return entry_transpose_fixture(graph), torch.from_numpy(codes.astype(np.int8))


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_runner_keeps_the_eager_executor(fused):
    graph, x = _graph_and_input(fused)
    runner = TFLiteSimRunner(graph, device="cpu")
    fwd = runner.executor(B, prequantized_input=fused)
    assert not isinstance(fwd, _GraphedCall)
    assert runner.executor(B, prequantized_input=fused) is fwd
    ref = build_executor(graph, B, device="cpu", prequantized_input=fused)
    assert type(fwd) is type(ref) and fwd.__name__ == ref.__name__
    np.testing.assert_array_equal(fwd(x).numpy(), ref(x).numpy())
    if not fused:
        np.testing.assert_array_equal(runner.predict(x.numpy()), ref(x).numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_runner_executor_steps(fused):
    graph, _ = _graph_and_input(fused)
    fwd = TFLiteSimRunner(graph, device="cpu").executor(B, prequantized_input=fused)
    assert fwd.steps == build_executor(graph, B, device="cpu",
                                       prequantized_input=fused).steps
    assert fwd.steps == (55 if fused else 57)



# The float runner. FLAGSHIP is the DS-CNN the bf16 cells serve; B1_SMALL
# EfficientNet-B1 at its full widths on a small spectrogram input
# (tests/test_torch_efficientnet.py's SMALL).
FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts/flagship/bundle/model_config.json"
B1_SMALL = {"model": "efficientnet", "architecture": "efficientnet_b1", "sample_rate": 8000,
            "chunk_duration": 1.0, "num_mels": 32, "spec_width": 64, "fft_length": 128,
            "audio_frontend": "librosa", "mag_scale": "pwl", "embeddings_size": 1280,
            "num_classes": 100}
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
ROWS = 64  # the benchmark's rows a request


@pytest.fixture(scope="module")
def flagship_cfg():
    return ModelConfig.load(FLAGSHIP)


def _dscnn(cfg, device):
    return init_model(build_dscnn(cfg, class_activation="sigmoid", device=device), seed=0)


def _b1(device):
    return build_efficientnet(ModelConfig.from_dict(B1_SMALL), "sigmoid", device=device)


def _features(cfg, rows, seed, device):
    """[rows, 257, 256, 1] spectrogram-like features in [0, 1] (the hybrid
    frontend's input)."""
    g = torch.Generator().manual_seed(seed)
    bins = cfg.fft_length // 2 + 1
    return torch.rand(rows, bins, cfg.spec_width, 1, generator=g).to(device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_torch_runner_stays_eager(flagship_cfg, dtype):
    """On the CPU forward_block builds no graph and equals infer_block on
    the runner's replica bit for bit; forward and predict agree with it."""
    runner = TorchRunner(_dscnn(flagship_cfg, "cpu"), flagship_cfg, device="cpu",
                         dtype=DTYPES[dtype])
    x = _features(flagship_cfg, 2, 1, "cpu")
    assert runner.graphable and not runner.graphs_engage(x.device)
    want = infer_block(runner.replicas, x, runner.dtype)
    for got in (runner.forward_block(x), runner.forward_block(x.clone()), runner.forward(x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(runner.predict(x.numpy()), want.numpy())
    assert runner._calls == {}


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_type_rule_graphs_the_dscnn_and_not_efficientnet(flagship_cfg, dtype):
    """By layer type: the DS-CNN opens no spans of its own, so its blocks on
    a card are graphed; EfficientNet-B1's MBConv blocks open mbconv.*, so
    it stays eager, in its bf16 copy too."""
    dscnn, b1 = _dscnn(flagship_cfg, "cpu"), _b1("cpu")
    assert not opens_spans(dscnn) and opens_spans(b1)
    card = torch.device("cuda", 0)
    graphed = TorchRunner(dscnn, flagship_cfg, device="cpu", dtype=DTYPES[dtype])
    eager = TorchRunner(b1, ModelConfig.from_dict(B1_SMALL), device="cpu", dtype=DTYPES[dtype])
    assert graphed.graphable and graphed.graphs_engage(card)
    assert not eager.graphable and not eager.graphs_engage(card)


def test_activation_fake_quant_keeps_the_runner_eager(flagship_cfg):
    """While the activation fake-quant hook is set, no block is graphed (a
    capture would freeze the hook), and the CPU forward runs the hook."""
    runner = TorchRunner(_dscnn(flagship_cfg, "cpu"), flagship_cfg, device="cpu")
    card = torch.device("cuda", 0)
    x = _features(flagship_cfg, 2, 2, "cpu")
    with activation_fake_quant():
        assert not runner.graphs_engage(card)
        hooked = runner.forward_block(x)
    assert runner.graphs_engage(card)
    assert not torch.equal(hooked, runner.forward_block(x))
    assert runner._calls == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")


@pytest.fixture
def spans_opened(monkeypatch):
    """The names of the spans the runners and the blocks open, in order,
    recorded without a profiler: a profiler session before a CUDA graph's
    capture can make a later session of the same process report one of
    the graph's kernels twice, so only test_torch_runner_span_on_card
    profiles the card."""
    from birdnet_stm32_tpu_torch.models import blocks, runners

    names = []

    def record(name):
        names.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(runners, "span", record)
    monkeypatch.setattr(blocks, "span", record)
    return names


def _card_runner(cfg, dtype, **kw):
    return TorchRunner(_dscnn(cfg, "cuda"), cfg, dtype=DTYPES[dtype], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_runner_replay_equals_eager_on_card(cuda, flagship_cfg, dtype, spans_opened):
    """At 64 flagship rows the capture call and two replays equal the eager
    forward on the same card bit for bit; each replay opens one
    torch.GRAPH span, the capture call none."""
    runner = _card_runner(flagship_cfg, dtype)
    x = _features(flagship_cfg, ROWS, 3, "cuda")
    want = infer_block(runner.replicas, x, runner.dtype).cpu()
    first = runner.forward_block(x)
    (call,) = runner._calls.values()
    assert call.graph is not None and not call.eager_only, "the capture fell back to eager"
    assert spans_opened == []
    for got in (first, runner.forward_block(x), runner.forward_block(x.clone())):
        assert got.dtype == torch.float32 and got.shape == (ROWS, flagship_cfg.num_classes)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert spans_opened == [TORCH_GRAPH, TORCH_GRAPH]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_runner_answers_are_its_own_on_card(cuda, flagship_cfg, dtype):
    """Two replays on different inputs each return their own answer, and
    the first, held across the second, is unchanged."""
    runner = _card_runner(flagship_cfg, dtype)
    a, b = (_features(flagship_cfg, ROWS, s, "cuda") for s in (11, 12))
    want_a, want_b = (infer_block(runner.replicas, v, runner.dtype).cpu() for v in (a, b))
    assert not torch.equal(want_a, want_b)
    runner.forward_block(b)
    ya = runner.forward_block(a)
    yb = runner.forward_block(b)
    (call,) = runner._calls.values()
    assert len({ya.data_ptr(), yb.data_ptr(), call.static_out.data_ptr()}) == 3
    torch.testing.assert_close(ya.cpu(), want_a, rtol=0, atol=0)
    torch.testing.assert_close(yb.cpu(), want_b, rtol=0, atol=0)


@pytest.mark.cuda
def test_torch_runner_checks_its_input_on_card(cuda, flagship_cfg):
    """After the capture a wrong trailing shape (which copy_ would
    broadcast) raises ValueError through forward_block, and the graph
    itself refuses a wrong batch, dtype or device; another batch size or
    input dtype is another key."""
    runner = _card_runner(flagship_cfg, "bfloat16")
    x = _features(flagship_cfg, ROWS, 4, "cuda")
    runner.forward_block(x)
    (call,) = runner._calls.values()
    assert call.graph is not None
    with pytest.raises(ValueError, match="TorchRunner forward for"):
        runner.forward_block(x[:, :, :1].contiguous())
    for bad in (x[:3], x.to(torch.float64), x.cpu()):
        with pytest.raises(ValueError, match="TorchRunner forward for"):
            call(bad)
    runner.forward_block(x[:8])
    runner.forward_block(x.to(torch.bfloat16))
    assert len(runner._calls) == 3


@contextlib.contextmanager
def _refused_capture(*args, **kwargs):
    raise RuntimeError("capture refused")
    yield


@pytest.mark.cuda
def test_torch_runner_capture_failure_falls_back_on_card(cuda, flagship_cfg, monkeypatch,
                                                         capsys, spans_opened):
    """A capture that raises leaves the key eager from then on, said once
    on stderr; every call equals the eager forward and opens no
    torch.GRAPH span."""
    runner = _card_runner(flagship_cfg, "bfloat16")
    x = _features(flagship_cfg, ROWS, 5, "cuda")
    want = infer_block(runner.replicas, x, runner.dtype).cpu()
    monkeypatch.setattr(torch.cuda, "graph", _refused_capture)
    got = [runner.forward_block(x) for _ in range(3)]
    (call,) = runner._calls.values()
    assert call.eager_only and call.graph is None
    warnings = [line for line in capsys.readouterr().err.splitlines() if "[warn]" in line]
    assert len(warnings) == 1 and "TorchRunner forward: CUDA graph capture failed" in warnings[0]
    for y in got:
        torch.testing.assert_close(y.cpu(), want, rtol=0, atol=0)
    assert spans_opened == []


@pytest.mark.cuda
def test_efficientnet_runner_never_builds_a_graph_on_card(cuda, spans_opened):
    """EfficientNet-B1 on a card stays eager: no graph after repeated
    calls, and every call opens its blocks' mbconv.dw spans and no
    torch.GRAPH span."""
    runner = TorchRunner(_b1("cuda"), ModelConfig.from_dict(B1_SMALL), dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(6)
    x = torch.rand(2, B1_SMALL["num_mels"], B1_SMALL["spec_width"], 1, generator=g).cuda()
    for _ in range(4):
        runner.forward_block(x)
    names = Counter(spans_opened)
    assert runner._calls == {} and not runner.graphable
    assert names[MBCONV_DW] == 4 * len(runner.model.blocks) and names[TORCH_GRAPH] == 0


@pytest.mark.cuda
def test_torch_runner_span_on_card(cuda, flagship_cfg, tmp_path):
    """Under torch.profiler a replay records exactly one torch.GRAPH span,
    every kernel and copy of the block is launched inside it, and the
    replay runs the eager forward's kernels."""
    from torch.profiler import ProfilerActivity, profile

    runner = _card_runner(flagship_cfg, "bfloat16")
    x = _features(flagship_cfg, ROWS, 7, "cuda")
    runner.forward_block(x)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        runner.forward_block(x)
        torch.cuda.synchronize()
    device, spans = _kernels_and_spans(prof, tmp_path / "graph.json", TORCH_GRAPH)
    assert [name for name, _, _ in spans] == [TORCH_GRAPH]
    (_, t0, t1) = spans[0]
    assert device and all(t is not None and t0 <= t <= t1 for _, _, t in device), device[:5]
    with profile(activities=acts) as prof:
        infer_block(runner.replicas, x, runner.dtype)
        torch.cuda.synchronize()
    eager, no_spans = _kernels_and_spans(prof, tmp_path / "eager.json", TORCH_GRAPH)
    kernels = Counter(n for c, n, _ in device if c == "kernel")
    assert not no_spans
    assert kernels and kernels == Counter(n for c, n, _ in eager if c == "kernel")


@pytest.mark.cuda
def test_torch_runner_mesh_two_entries_on_card(cuda, flagship_cfg):
    """A mesh of cuda:0 twice: both row blocks share one graph, and three
    calls (capture, then replays) equal the eager forward of each block
    bit for bit."""
    runner = _card_runner(flagship_cfg, "bfloat16", mesh=["cuda:0", "cuda:0"])
    for seed in range(3):
        x = _features(flagship_cfg, 16, 20 + seed, "cuda")
        want = torch.cat([infer_block(runner.replicas, b, runner.dtype) for b in x.chunk(2)])
        torch.testing.assert_close(runner.forward(x), want, rtol=0, atol=0)
    (call,) = runner._calls.values()
    assert isinstance(call, _GraphedCall) and call.graph is not None
