"""EfficientNet-B1's files in the benchmark: the configuration resolves to
the port's builder, the plain reference and the MAC count by name;
BENCHMARK.json holds its configuration, the cell `effb1-b64-int16` and the
three MBConv readers; the reference agrees with the port in float32 and
its fp8 control fails the configuration's limit; the whole cell on the CPU
at a small mix is `correct`, and false under the faults test's altered
answer; and the readers of the MBConv spans read a hand-built trace.

What the cell's `correct` cannot see: under gpubench/weights.py's seeding
two chunks' scores differ by less than the configuration's limit
(test_seeded_scores_barely_depend_on_the_chunk), so a stale or swapped
answer passes it here; a fault of the weights or of the model's arithmetic
does not."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import correctness, harness, reference, system, traffic
from gpubench.reference import efficientnet, frontend
from gpubench.tests.test_gpubench_faults import SMALL, altered_answer
from gpubench.trace import REQUEST_SPAN, Event, Trace
from gpubench.weights import seeded_state
from gpubench.yardstick import macs_efficientnet
from gpubench.yardstick.macs import model_macs
from gpubench.yardstick.peaks import HBM_BYTES_PER_S, OPS_PER_S

ROOT = Path(__file__).resolve().parents[2]
CELL = "effb1-b64-int16"
CONFIG_FILE = ROOT / "gpubench/configs/effnet-b1-bf16.json"
CONFIG = json.loads(CONFIG_FILE.read_text())
MIX = json.loads((ROOT / "gpubench/traffic/closed-b64-int16.json").read_text())
SEED = 2**31 + 71


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(config, class_activation="sigmoid"):
    from birdnet_stm32_tpu_torch.config import ModelConfig

    model = system.builder(config["builder"])(ModelConfig.from_dict(config),
                                              class_activation=class_activation, device="cpu")
    state = seeded_state(model.state_dict(), config, SEED, "cpu")
    model.load_state_dict(state, strict=False)
    return model, state


def test_configuration_resolves_to_efficientnet():
    from birdnet_stm32_tpu_torch.models.efficientnet import build_efficientnet

    assert harness.load_config(CONFIG_FILE) == CONFIG
    assert system.builder(CONFIG["builder"]) is build_efficientnet
    ref = reference.model(CONFIG["model"])
    assert Path(ref.__file__) == ROOT / "gpubench/reference/efficientnet.py"
    assert not hasattr(ref, "features") and not hasattr(ref, "seeded")
    assert model_macs(CONFIG) == macs_efficientnet.model_macs(CONFIG) == 944_405_440


def test_seeding_covers_every_parameter_by_the_name_rules():
    # Keras's names put every BN under "_bn." and every other parameter is
    # a 4-D kernel, a 2-D dense weight or a bias: no `seeded` hook runs.
    model, state = _seeded(CONFIG)
    floats = {k for k, v in model.state_dict().items() if v.is_floating_point()}
    assert set(state) == floats
    assert all(".weight" not in k or "_bn." in k or state[k].dim() in (2, 4)
               for k in state if not k.startswith("audio_frontend"))

def test_cell_and_readers_in_benchmark_json():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    entry = configs[CONFIG["name"]]
    assert ROOT / entry["file"] == CONFIG_FILE and entry["reduced"] == []
    assert entry["source"] in CONFIG["source"]
    assert {k: cells[CELL][k] for k in ("config", "traffic", "chips")} == {
        "config": CONFIG["name"], "traffic": "closed-b64-int16", "chips": 1}
    readers = {m["name"]: m for m in bench["per_layer"] if m["name"].startswith("mbconv_")}
    assert sorted(readers) == ["mbconv_dw_roofline", "mbconv_pw_roofline", "mbconv_se_ms"]
    for m in readers.values():
        assert (m["workloads"], m["moves"], m["source"], m["layer"]) == (
            [CELL], "chunks_per_s", "device_trace", "model")
        assert (ROOT / f"gpubench/metrics/{m['name']}.py").is_file()


@pytest.mark.parametrize("control", [False, True], ids=["float32", "fp8-control"])
def test_reference_against_the_port(control):
    # At the configuration's widths and geometry, 2 rows. In float32 the
    # reference and the port run the same convolution routines and differ
    # only in the order of BN's operations: 1e-5 of a score. The control
    # (fp8 e4m3 operands) has to miss the configuration's limit.
    config = {**CONFIG, "precision": "float32"}
    model, state = _seeded(config)
    pool = traffic.make_pool({**MIX, "rows": 2, "pool": 1}, config, SEED)
    feats = torch.from_numpy(frontend.features(pool[0], config, MIX))
    with torch.no_grad():
        port = model(feats)
    cast = correctness._fp8 if control else (lambda x: x)
    ref = efficientnet.scores(state, feats, config, cast)
    gap = float((port - ref).abs().max())
    if control:
        assert gap > CONFIG["score_gap_limit"]
    else:
        assert gap < 1e-5


def test_cpu_cell_is_correct_and_an_altered_answer_is_not():
    def run(wrap=None):
        return harness.run_cell(CELL, SEED, 0.3, False, time.perf_counter(), devices=["cpu"],
                                wrap=wrap, mix_update=SMALL)

    sound, sound_checks = run()
    broken, checks = run(altered_answer)
    assert sound["correct"] is True and sound["failed"] == 0, sound_checks
    assert sound_checks["score_gap"]["limit"] == CONFIG["score_gap_limit"]
    assert broken["correct"] is False
    assert checks["score_gap"]["value"] > 4 * CONFIG["score_gap_limit"]


def test_macs_and_reader_counts_by_hand():
    # block1a's depthwise 3x3 on 32 channels at 80 x 250 (stride 1), then
    # block2a's on 96 channels from 80 x 250 to 40 x 125 (stride 2):
    # input, output and weights in bytes at bfloat16.
    layers = [x for x in macs_efficientnet._layers(160, 500) if x[0] == "dw"]
    assert layers[0][1:] == (9 * 32 * 80 * 250, 32 * 80 * 250, 32 * 80 * 250, 32 * 9)
    assert layers[2][1:] == (9 * 96 * 40 * 125, 96 * 80 * 250, 96 * 40 * 125, 96 * 9)
    assert len(layers) == 23
    n_bytes = sum(2 * (64 * (r + w) + k) for _, _, r, w, k in layers)
    assert macs_efficientnet.depthwise_bytes(CONFIG, 64) == n_bytes
    # block2a's expand: 16 -> 96 at 80 x 250; its project 96 -> 24 at 40 x 125.
    pw = [x[1] for x in macs_efficientnet._layers(160, 500) if x[0] in ("expand", "project")]
    assert pw[2:4] == [80 * 250 * 16 * 96, 40 * 125 * 96 * 24]
    assert macs_efficientnet.pointwise_flops(CONFIG, 64) == 2.0 * 64 * sum(pw)


def _span(name, ts, end):
    return Event(name, -1, float(ts), float(end - ts), -1, 1)


def _trace() -> Trace:
    """Two requests (0-100, 100-200 us); kernels launched inside mbconv.dw
    (10 + 20 us of device time), mbconv.expand and mbconv.project (5 + 7),
    mbconv.se (3), and one outside any MBConv span (40)."""
    tr = Trace()
    tr.spans = [_span(REQUEST_SPAN, 0, 100), _span("serve.model", 5, 95),
                _span("mbconv.expand", 10, 12), _span("mbconv.dw", 12, 14),
                _span("mbconv.se", 14, 16), _span("mbconv.project", 16, 18),
                _span(REQUEST_SPAN, 100, 200), _span("serve.model", 105, 195),
                _span("mbconv.dw", 112, 114)]
    tr.kernels = [Event("e", 0, 20, 5, corr=1), Event("d", 0, 30, 10, corr=2),
                  Event("s", 0, 40, 3, corr=3), Event("p", 0, 50, 7, corr=4),
                  Event("d", 0, 130, 20, corr=5), Event("o", 0, 150, 40, corr=6)]
    tr.launches = {1: 11.0, 2: 13.0, 3: 15.0, 4: 17.0, 5: 113.0, 6: 150.0}
    return tr


def test_mbconv_readers_on_a_hand_built_trace():
    ctx = harness.TraceContext(_trace(), 2, 64, 1, CONFIG, 0, 0.0)
    dw_s = macs_efficientnet.depthwise_bytes(CONFIG, 64) / HBM_BYTES_PER_S
    pw_s = macs_efficientnet.pointwise_flops(CONFIG, 64) / OPS_PER_S["bfloat16"]
    assert harness.read_metric("mbconv_dw_roofline", ctx) == pytest.approx(
        100 * dw_s / (30e-6 / 2))
    assert harness.read_metric("mbconv_pw_roofline", ctx) == pytest.approx(
        100 * pw_s / (12e-6 / 2))
    assert harness.read_metric("mbconv_se_ms", ctx) == pytest.approx(3e-3 / 2)
    # A program without the spans (the flagship's, or the parent's) leaves
    # each reader nothing to read.
    tr = _trace()
    tr.spans = [s for s in tr.spans if not s.name.startswith("mbconv.")]
    bare = harness.TraceContext(tr, 2, 64, 1, CONFIG, 0, 0.0)
    for name in ("mbconv_dw_roofline", "mbconv_pw_roofline", "mbconv_se_ms"):
        assert harness.read_metric(name, bare) is None, name


def test_seeded_scores_barely_depend_on_the_chunk():
    # What the cell's `correct` cannot see. With gpubench/weights.py's BN
    # statistics near identity, SiLU (slope 1/2 at 0) and the SE gate
    # (~0.5) shrink the input's part at every block: the scores of distinct
    # chunks differ by less than the configuration's limit, while they
    # spread over the classes by more than ten times it, so a stale or
    # swapped answer passes `correct`. A seeding that gives the cell an
    # input-sensitive `correct` has to turn the first assertion round, by
    # a wide margin.
    pool = traffic.make_pool({**MIX, "rows": 4, "pool": 1}, CONFIG, SEED)
    _, state = _seeded({**CONFIG, "precision": "float32"})
    scores = efficientnet.scores(state, torch.from_numpy(frontend.features(pool[0], CONFIG,
                                                                           MIX)), CONFIG)
    s = scores.numpy().astype(np.float64)
    over_rows = np.abs(s[:, None] - s[None]).max()
    assert over_rows < CONFIG["score_gap_limit"]
    assert np.ptp(s, axis=1).min() > 10 * CONFIG["score_gap_limit"]
