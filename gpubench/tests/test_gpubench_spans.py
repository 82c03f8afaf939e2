"""The readers of the program's spans (gpubench/spans.py and the seven
metrics that read serve.* and tflite.* spans): on hand-built traces with
known intervals, on a trace without the spans (a program that records
none), and in a traced run of the INT8 and bf16 cells on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import harness, spans
from gpubench.trace import REQUEST_SPAN, Event, Trace

SMALL = {"rows": 4, "pool": 2, "warmup_rounds": 1, "trace_calls": 2}
HOST_METRICS = ("entry_self_ms", "egress_wait_ms", "ingress_host_ms", "model_issue_ms")
NEW = HOST_METRICS + ("executor_ops_per_batch", "model_idle_ms", "model_busy_ms")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def span(name, ts, end, tid=1):
    return Event(name, -1, float(ts), float(end - ts), -1, tid)


def device(kind, dev, ts, end):
    return Event(kind, dev, float(ts), float(end - ts))


def two_requests() -> Trace:
    """Two requests of the harness (0-100 and 100-200 us) on thread 1, each
    holding the program's serve.request; the first holds children that
    overlap, an op span inside its model span, and a span of thread 2 over
    it that is no child."""
    tr = Trace()
    tr.spans = [
        span(REQUEST_SPAN, 0, 100), span(spans.REQUEST, 5, 95),
        span(spans.INGRESS, 10, 20), span(spans.FRONTEND, 15, 30),
        span(spans.MODEL, 30, 80), span("tflite.ADD", 35, 40),
        span("tflite.CONV_2D", 40, 44), span(spans.EGRESS, 85, 90),
        span("other.thread", 0, 100, tid=2),
        span(REQUEST_SPAN, 100, 200), span(spans.REQUEST, 105, 195),
        span(spans.MODEL, 130, 180), span("tflite.ADD", 140, 150),
    ]
    # Card 0: overlapping kernels, and one past the window's end; card 1: a
    # copy over the first request's start and a kernel.
    tr.kernels = [device("k", 0, 40, 50), device("k", 0, 45, 60), device("k", 0, 170, 250),
                  device("k", 1, 120, 140)]
    tr.copies = [device("Memcpy HtoD", 1, 0, 35)]
    return tr


def ctx(tr: Trace, cards: int = 2, calls: int = 2) -> harness.TraceContext:
    return harness.TraceContext(tr, calls, 4, cards, {}, 0, 0.0)


def test_interval_arithmetic():
    assert spans.merged([(3, 5), [0, 2], (1, 4), (6, 6)]) == [[0, 5]]
    assert spans.length([(0, 2), (1, 4), (10, 11)]) == 5
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == [[5, 10], [20, 25]]
    assert spans.intersect([(0, 1)], []) == []
    assert spans.complement([(2, 3), (5, 12)], 0, 10) == [[0, 2], [3, 5]]
    assert spans.complement([], 0, 10) == [[0, 10]]


def test_entry_self_ms_subtracts_the_union_of_children():
    # First request: 90 us less the union of [10, 30] (ingress and frontend
    # overlap), [30, 80] (model, holding the op spans) and [85, 90]: 15 us.
    # Second: 90 less its model span [130, 180]: 40 us. The span of thread 2
    # and the harness's own request span are no children.
    got = harness.read_metric("entry_self_ms", ctx(two_requests()))
    assert got == pytest.approx((15 + 40) * 1e-3 / 2)


def test_model_idle_ms_intersects_each_cards_idle_time_with_the_model_spans():
    # Model spans [30, 80] and [130, 180]. Card 0 busy [40, 60] and
    # [170, 200] (clipped to the window): idle in them 10 + 20 + 40 us.
    # Card 1 busy [0, 35] and [120, 140]: idle in them 45 + 40 us.
    tr = two_requests()
    assert harness.read_metric("model_idle_ms", ctx(tr)) == pytest.approx(155e-3 / 2)
    # A third card with no event idles through both model spans.
    assert harness.read_metric("model_idle_ms", ctx(tr, cards=3)) == pytest.approx(255e-3 / 2)


def test_model_busy_ms_sums_the_kernels_launched_in_serve_model():
    # Kernels launched at 35 and 140 us, inside the model spans [30, 80] and
    # [130, 180], count with their device time; one launched at 12 us, in
    # serve.ingress, and one with no launch record do not.
    tr = two_requests()
    tr.kernels = [Event("k", 0, 40, 10, corr=1), Event("k", 1, 150, 30, corr=2),
                  Event("k", 0, 20, 5, corr=3), Event("k", 0, 60, 7)]
    tr.launches = {1: 35.0, 2: 140.0, 3: 12.0}
    assert harness.read_metric("model_busy_ms", ctx(tr)) == pytest.approx(40e-3 / 2)


def test_host_span_readers_sum_per_request():
    c = ctx(two_requests())
    assert harness.read_metric("ingress_host_ms", c) == pytest.approx(10e-3 / 2)
    assert harness.read_metric("model_issue_ms", c) == pytest.approx(100e-3 / 2)
    assert harness.read_metric("egress_wait_ms", c) == pytest.approx(5e-3 / 2)
    assert harness.read_metric("executor_ops_per_batch", c) == 3 / 2


def test_a_program_without_spans_leaves_each_reader_nothing():
    tr = two_requests()
    tr.spans = [s for s in tr.spans if s.name == REQUEST_SPAN]
    for name in NEW:
        assert harness.read_metric(name, ctx(tr)) is None, name


@pytest.mark.parametrize("workload", ["int8-b64-int16", "bf16-b64-int16"])
def test_traced_cpu_run_reads_the_program_spans(workload):
    line, _ = harness.run_cell(workload, 2**31 + 29, 0.3, True, time.perf_counter(),
                               devices=["cpu"], mix_update=SMALL)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(HOST_METRICS) <= set(got)
    assert all(got[k] > 0 for k in HOST_METRICS)
    assert "model_idle_ms" not in got  # the CPU run traces no device
    if workload.startswith("int8"):
        from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor

        _, _, config, _ = harness.load_cell(workload)
        steps = build_executor(TFLiteGraph(harness.ROOT / config["tflite"]), SMALL["rows"],
                               device="cpu").steps
        assert got["executor_ops_per_batch"] == steps == 57
    else:
        assert "executor_ops_per_batch" not in got
