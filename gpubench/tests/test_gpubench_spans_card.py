"""The program's spans on the card share the device trace's clock: in a
profiled run of each one-card cell, the frontend kernel is launched inside
serve.frontend, every host-to-device copy is issued inside serve.ingress,
and on the INT8 cell every kernel launched in serve.model is launched
inside a tflite.<OP> span. Needs a CUDA device; skips without one:

    python -m pytest gpubench/tests/test_gpubench_spans_card.py -m cuda -q
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from gpubench import harness, spans, system, trace, traffic
from gpubench.metrics.frontend_roofline import KERNELS as FRONTEND_KERNELS

ROOT = Path(__file__).resolve().parents[2]
ONE_CARD = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
            if w["chips"] == 1]
SEED = 2**31 + 41
CALLS = 3


def _within(t, intervals) -> bool:
    return t is not None and any(a <= t <= b for a, b in intervals)


def _intervals(tr, match) -> list:
    return [(s.ts, s.end) for s in tr.spans if match(s.name)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_program_spans_share_the_device_clock(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import record_function

    _, _, config, mix = harness.load_cell(workload)
    mix.update(pool=1)
    sut = system.build(config, mix, SEED, ["cuda:0"], ROOT)
    (batch,) = traffic.make_pool(mix, config, SEED, "cuda:0")
    sut.classify(batch)
    torch.cuda.synchronize()

    def calls():
        for _ in range(CALLS):
            with record_function(trace.REQUEST_SPAN):
                sut.classify(batch)
    tr = trace.read(trace.profile(calls))
    assert len(spans.named(tr, spans.REQUEST)) == CALLS

    frontend = [k for k in tr.kernels if any(n in k.name for n in FRONTEND_KERNELS)]
    assert len(frontend) == CALLS
    inside = _intervals(tr, lambda n: n == spans.FRONTEND)
    assert all(_within(tr.launches.get(k.corr), inside) for k in frontend)

    h2d = [c for c in tr.copies if "HtoD" in c.name]
    inside = _intervals(tr, lambda n: n == spans.INGRESS)
    outside = [(c.name, c.dur) for c in h2d if not _within(tr.launches.get(c.corr), inside)]
    assert h2d and not outside, outside

    if config["runner"] == "tflite_sim":
        model = tr.launched_in(spans.MODEL)
        assert model
        ops = _intervals(tr, lambda n: n.startswith(spans.OP_PREFIX))
        loose = [k.name for k in model if not _within(tr.launches.get(k.corr), ops)]
        assert not loose, loose[:5]
