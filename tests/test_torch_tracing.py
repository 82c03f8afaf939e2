"""PyTorch port, the serving path's spans (utils/tracing.py): under
torch.profiler (CPU activity) each classify call of the fused classifier,
on the INT8 leg (the flagship graph at B=2), the float32 and bf16 legs (a
small DS-CNN) and the interpreter leg, with no mesh and with a mesh of two
CPU entries, is one serve.request holding one serve.ingress and one
serve.egress and a serve.frontend and a serve.model per block, on one
thread; the INT8 executor adds a tflite.<OP> span per computed step
(`executor.steps`) inside each serve.model. Without a profiler no
record_function is entered, and the scores are bit-equal either way."""

import functools
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models import serving as P
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
from birdnet_stm32_tpu_torch.utils import tracing
from tests.int8_fixture import FLAGSHIP_TFLITE
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401

warm_up()

FLAGSHIP_CONFIG = Path(__file__).resolve().parents[1] / "artifacts/flagship/bundle/model_config.json"
SMALL = dict(sample_rate=8000, num_mels=32, spec_width=32, fft_length=256,
             chunk_duration=1.0, embeddings_size=32, num_classes=4,
             class_names=list("abcd"), alpha=0.25, audio_frontend="hybrid",
             mag_scale="pwl", use_se=False, use_inverted_residual=False)
B = 2
MESHES = {"nomesh": None, "mesh2": ["cpu", "cpu"]}
LEGS = ("int8", "float32", "bf16")
SERVE = (tracing.REQUEST, tracing.INGRESS, tracing.FRONTEND, tracing.MODEL, tracing.EGRESS)


class HostRunner:
    """The interpreter leg's interface (`predict` on host arrays), without
    TensorFlow: the row sums of the features as two scores."""

    def predict(self, x):
        s = x.reshape(x.shape[0], -1).sum(axis=1, keepdims=True)
        return np.concatenate([s, -s], axis=1)


@functools.lru_cache(maxsize=None)
def _small_model():
    cfg = ModelConfig.from_dict(SMALL)
    return cfg, init_model(build_dscnn(cfg, device="cpu"), seed=0)


def _classifier(leg: str, mesh):
    """(classify, runner, config) of one leg on the CPU."""
    if leg == "int8":
        cfg = ModelConfig.load(FLAGSHIP_CONFIG)
        runner = TFLiteSimRunner(FLAGSHIP_TFLITE, device="cpu", mesh=mesh)
    elif leg == "interpreter":
        cfg, runner = _small_model()[0], HostRunner()
    else:
        cfg, model = _small_model()
        runner = TorchRunner(model, cfg, device="cpu", mesh=mesh,
                             dtype=torch.bfloat16 if leg == "bf16" else None)
    return P.make_fused_classifier(runner, cfg, device="cpu"), runner, cfg


def _wave(cfg, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.1, (B, cfg.chunk_samples)).astype(np.float32)


def _traced(classify, waves):
    """(the scores of each wave, the program's span events) with the
    profiler recording the CPU."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scores = [classify(w) for w in waves]
    return scores, [e for e in prof.events()
                    if e.name in SERVE or e.name.startswith(tracing.OP_PREFIX)]


def _inside(e, outer) -> bool:
    return (e.thread == outer.thread and e.time_range.start >= outer.time_range.start
            and e.time_range.end <= outer.time_range.end)


CASES = [(leg, m) for leg in LEGS for m in MESHES] + [("interpreter", "nomesh")]


@pytest.mark.parametrize("leg,mesh", CASES, ids=[f"{leg}-{m}" for leg, m in CASES])
def test_each_request_holds_its_spans(leg, mesh):
    classify, runner, cfg = _classifier(leg, MESHES[mesh])
    blocks = len(MESHES[mesh] or [None])
    classify(_wave(cfg))  # builds the executors outside the trace
    _, events = _traced(classify, [_wave(cfg, 1), _wave(cfg, 2)])
    requests = [e for e in events if e.name == tracing.REQUEST]
    assert len(requests) == 2
    steps = runner.executor(B // blocks, device=torch.device("cpu")).steps if leg == "int8" else 0
    for r in requests:
        held = [e for e in events if e is not r and _inside(e, r)]
        counts = Counter(e.name for e in held if e.name in SERVE)
        assert counts == {tracing.INGRESS: 1, tracing.EGRESS: 1,
                          tracing.FRONTEND: blocks, tracing.MODEL: blocks}
        for m in (e for e in held if e.name == tracing.MODEL):
            ops = [e for e in held if e.name.startswith(tracing.OP_PREFIX) and _inside(e, m)]
            assert len(ops) == steps
    # No span lies outside a request, and every op span inside a model span.
    assert all(any(_inside(e, r) for r in requests) for e in events)
    assert len({e.thread for e in events}) == 1
    ops = [e for e in events if e.name.startswith(tracing.OP_PREFIX)]
    assert len(ops) == 2 * blocks * steps
    if leg == "int8":
        assert steps == 57  # the flagship graph's entry form
        assert {e.name for e in ops} >= {"tflite.CONV_2D", "tflite.DEPTHWISE_CONV_2D",
                                          "tflite.ADD", "tflite.LOGISTIC"}


@pytest.mark.parametrize("leg,mesh", CASES, ids=[f"{leg}-{m}" for leg, m in CASES])
def test_scores_are_bit_equal_traced_and_untraced(leg, mesh):
    classify, _, cfg = _classifier(leg, MESHES[mesh])
    wave = _wave(cfg, 3)
    plain = classify(wave)
    (traced,), events = _traced(classify, [wave])
    assert events
    np.testing.assert_array_equal(traced, plain)
    np.testing.assert_array_equal(classify(wave), plain)


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered without a profiler")


@pytest.mark.parametrize("leg", LEGS + ("interpreter",))
def test_no_profiler_enters_no_record_function(leg, monkeypatch):
    classify, _, cfg = _classifier(leg, MESHES["mesh2"] if leg != "interpreter" else None)
    wave = _wave(cfg, 4)
    plain = classify(wave)
    monkeypatch.setattr(tracing, "record_function", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    assert not tracing.recording()
    np.testing.assert_array_equal(classify(wave), plain)


def test_span_is_the_shared_noop_without_a_profiler():
    assert not tracing.recording()
    assert tracing.span(tracing.REQUEST) is tracing.span("tflite.ADD") is tracing._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        s = tracing.span("x.y")
        assert s is not tracing._NO_SPAN
        with s:
            pass
    assert not tracing.recording()
    assert [e.name for e in prof.events() if e.name == "x.y"] == ["x.y"]


def test_executor_spans_name_each_computed_op():
    """The executor's op spans follow the graph's computed ops in order;
    without the layout pre-passes every op computes and gets its span."""
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    f = build_executor(graph, 1, device="cpu", layout_prepasses=False)
    x = torch.zeros((1, *graph.tensors[graph.inputs[0]].shape[1:]), dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f(x)
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.name.startswith(tracing.OP_PREFIX)]
    assert names == [tracing.OP_PREFIX + op.name for op in graph.ops]
    assert len(names) == f.steps
