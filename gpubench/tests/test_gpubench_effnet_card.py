"""The MBConv spans on the card: in a profiled run of EfficientNet-B1
(gpubench/configs/effnet-b1-bf16.json) under the flagship's traffic,
each request's serve.model holds mbconv.expand, mbconv.dw, mbconv.se and
mbconv.project for each of the 23 blocks (no expand where the expansion
is 1), and each kind has kernels launched inside it, which the MBConv
readers then read. Needs a CUDA device; skips without one:

    python -m pytest gpubench/tests/test_gpubench_effnet_card.py -m cuda -q
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from gpubench import harness, spans, system, trace, traffic

ROOT = Path(__file__).resolve().parents[2]
CONFIG_FILE = ROOT / "gpubench/configs/effnet-b1-bf16.json"
SEED = 2**31 + 43
CALLS = 2
# Spans per request: 23 blocks, two of them (block1a, block1b) without an
# expand convolution.
PER_CALL = {"mbconv.expand": 21, "mbconv.dw": 23, "mbconv.se": 23, "mbconv.project": 23}


@pytest.mark.cuda
def test_mbconv_spans_nest_in_serve_model_and_hold_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import record_function

    config, mix = harness.load_config(CONFIG_FILE), traffic.load("closed-b64-int16")
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
    model = [(s.ts, s.end) for s in spans.named(tr, spans.MODEL)]
    assert len(model) == CALLS
    in_model = {id(k) for k in tr.launched_in(spans.MODEL)}
    for name, n in PER_CALL.items():
        inner = spans.named(tr, name)
        assert len(inner) == n * CALLS, name
        assert all(any(a <= s.ts and s.end <= b for a, b in model) for s in inner), name
        kernels = tr.launched_in(name)
        assert kernels and all(id(k) in in_model for k in kernels), name
    metrics = harness.TraceContext(tr, CALLS, mix["rows"], 1, config, 0, 0.0)
    for name in ("mbconv_dw_roofline", "mbconv_pw_roofline"):
        assert 0.0 < harness.read_metric(name, metrics) < 100.0, name
    assert harness.read_metric("mbconv_se_ms", metrics) > 0.0
