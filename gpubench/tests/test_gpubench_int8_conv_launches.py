"""The reader of int8_conv_launches_per_batch: device kernels named
int8_conv* launched inside the program's serve.model spans, per request,
on hand-built traces (every body convolution served, none as in a program
without the kernels, kernels of that name outside the model's span, a
graph replay whose kernels all share its one launch)."""

from __future__ import annotations

import pytest

from gpubench import harness, spans
from gpubench.trace import REQUEST_SPAN, Event, Trace

TAPS = "void int8_conv_taps_kernel<16, 0, false>(Taps)"
POINTWISE = "void int8_conv_pointwise_kernel<16, false, true>(Pointwise)"
OTHER = "void at::native::elementwise_kernel<128, 2>(int, Functor)"


def span(name, ts, end):
    return Event(name, -1, float(ts), float(end - ts), -1, 1)


def requests(n: int, model: list[str], frontend: list[str] = (), one_launch: bool = False) -> Trace:
    """n harness requests, each launching the `frontend` kernels inside
    serve.frontend and the `model` kernels inside serve.model: one launch
    each, or with one_launch all of them from one call (a graph replay)."""
    tr = Trace()
    corr = 0
    for i in range(n):
        t = 1000 * i
        tr.spans += [span(REQUEST_SPAN, t, t + 900), span(spans.REQUEST, t + 5, t + 895),
                     span(spans.FRONTEND, t + 10, t + 90), span(spans.MODEL, t + 100, t + 800)]
        for where, names in ((t + 20, frontend), (t + 110, model)):
            for j, name in enumerate(names):
                if not (one_launch and j):
                    corr += 1
                    tr.launches[corr] = where + (0 if one_launch else j)
                tr.kernels.append(Event(name, 0, where + 200 + j, 1.0, corr))
    return tr


def read(tr: Trace, calls: int):
    return harness.read_metric("int8_conv_launches_per_batch",
                               harness.TraceContext(tr, calls, 64, 1, {}, 0, 0.0))


FLAGSHIP = [TAPS] * 12 + [POINTWISE] * 11 + [OTHER] * 150


@pytest.mark.parametrize("one_launch", [False, True], ids=["eager", "graph_replay"])
def test_counts_the_body_kernels_in_the_model_span(one_launch):
    assert read(requests(3, FLAGSHIP, one_launch=one_launch), 3) == 23.0


def test_reads_zero_without_the_kernels():
    """The parent's executor: every model kernel is an aten one."""
    assert read(requests(2, [OTHER] * 700), 2) == 0.0


def test_kernels_outside_the_model_span_do_not_count():
    assert read(requests(2, [OTHER] * 5, frontend=[TAPS, POINTWISE]), 2) == 0.0
    assert read(requests(2, [TAPS, OTHER], frontend=[TAPS]), 2) == 1.0


def test_nothing_to_read_without_model_kernels():
    assert read(requests(2, [], frontend=[TAPS]), 2) is None
