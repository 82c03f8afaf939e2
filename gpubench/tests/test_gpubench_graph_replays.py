"""The reader of graph_replays_per_batch: the program's torch.GRAPH spans
per request, on hand-built traces (every block replayed, none, some) and
in a traced run of the bf16 cell on the CPU, where the float model stays
eager."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import harness, spans
from gpubench.trace import REQUEST_SPAN, Event, Trace

SMALL = {"rows": 4, "pool": 2, "warmup_rounds": 1, "trace_calls": 2}
GRAPH = "torch.GRAPH"


def span(name, ts, end):
    return Event(name, -1, float(ts), float(end - ts), -1, 1)


def requests(models: list[list[str]]) -> Trace:
    """One harness request per entry, each holding the program's
    serve.request and one serve.model per block, the block's model span
    holding the named spans."""
    tr = Trace()
    for i, blocks in enumerate(models):
        t = 1000 * i
        tr.spans += [span(REQUEST_SPAN, t, t + 900), span(spans.REQUEST, t + 5, t + 895)]
        for j, inner in enumerate(blocks):
            m = t + 100 + 200 * j
            tr.spans.append(span(spans.MODEL, m, m + 150))
            tr.spans += [span(name, m + 10, m + 140) for name in inner]
    return tr


def read(tr: Trace, calls: int):
    return harness.read_metric("graph_replays_per_batch",
                               harness.TraceContext(tr, calls, 4, 1, {}, 0, 0.0))


@pytest.mark.parametrize("models,want", [
    ([[[GRAPH]], [[GRAPH]]], 1.0),  # every block replayed
    ([[[]], [[]]], 0.0),  # every block eager, as the parent program records
    ([[[GRAPH]], [[]]], 0.5),  # the first call of a key runs eagerly
    ([[[GRAPH], [GRAPH]], [[GRAPH], [GRAPH]]], 2.0),  # two blocks a request
    ([[["tflite.GRAPH"]], [["tflite.CONV_2D"]]], 0.0),  # the INT8 executor's spans
], ids=["all", "none", "half", "two_blocks", "int8"])
def test_reads_torch_graph_spans_per_request(models, want):
    assert read(requests(models), len(models)) == want


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_traced_cpu_run_reads_zero(one_thread):
    line, _ = harness.run_cell("bf16-b64-int16", 2**31 + 31, 0.3, True, time.perf_counter(),
                               devices=["cpu"], mix_update=SMALL)
    assert line["metrics"]["graph_replays_per_batch"] == {"value": 0.0, "unit": "replays"}
