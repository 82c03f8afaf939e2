"""A configuration names its model: the builder (gpubench/system.py), the
plain reference (gpubench/reference/<model>.py) and the MAC count
(gpubench/yardstick/macs_<model>.py) are found by
name. The flagship configurations resolve to today's DS-CNN; a file that
names no model, and a builder outside the port, are refused; and a second
model, a stand-in (gpubench/tests/standin/), joins a copy of the benchmark
as new files only and runs a whole cell there on the CPU."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import correctness, harness, load_file, reference, system, traffic
from gpubench.reference import dscnn, frontend
from gpubench.weights import seeded_state
from gpubench.yardstick.macs import model_macs

ROOT = Path(__file__).resolve().parents[2]
STANDIN = Path(__file__).resolve().parent / "standin"
CONFIGS = {n: json.loads((ROOT / f"gpubench/configs/{n}.json").read_text())
           for n in ("flagship-int8", "flagship-bf16")}
MIX = json.loads((ROOT / "gpubench/traffic/closed-b64-int16.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flagship_configurations_resolve_to_todays_dscnn(name):
    config = CONFIGS[name]
    assert config["model"] == "dscnn"
    ref = reference.model(config["model"])
    assert Path(ref.__file__) == ROOT / "gpubench/reference/dscnn.py"
    assert not hasattr(ref, "features") and not hasattr(ref, "seeded")
    assert model_macs(config) == 27_296_768
    if config["runner"] == "torch":
        from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

        assert system.builder(config["builder"]) is build_dscnn


def test_reference_scores_equal_a_direct_dscnn_call():
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    config = CONFIGS["flagship-bf16"]
    model = build_dscnn(ModelConfig.from_dict(config), class_activation="sigmoid", device="cpu")
    weights = seeded_state(model.state_dict(), config, 2**31 + 11, "cpu")
    pool = traffic.make_pool({**MIX, "rows": 3, "pool": 2}, config, 2**31 + 11)
    got = correctness.reference_scores(config, MIX, pool, weights, ROOT)
    for batch, scores in zip(pool, got):
        feats = torch.from_numpy(frontend.features(batch, config, MIX))
        np.testing.assert_array_equal(scores, dscnn.scores(weights, feats, config).numpy())


def test_a_reference_may_bring_its_own_features(monkeypatch):
    class Ref:
        @staticmethod
        def features(batch, config, mix):
            return np.full((batch.shape[0], 2), 0.5, np.float32)

        @staticmethod
        def scores(sd, feats, config, cast):
            return cast(feats) * sd["w"]

    monkeypatch.setattr(reference, "model", lambda name: Ref)
    config = {**CONFIGS["flagship-bf16"], "model": "other"}
    (got,) = correctness.reference_scores(config, MIX, [np.zeros((3, 7))],
                                          {"w": torch.tensor(4.0)}, ROOT)
    np.testing.assert_array_equal(got, np.full((3, 2), 2.0, np.float32))


@pytest.mark.parametrize("helper", ["int8", "frontend", "mel", "tflite_file"])
def test_a_reference_helper_is_no_model(helper):
    with pytest.raises(ValueError, match=re.escape(f"model {helper!r}: ") + ".*defines no scores"):
        reference.model(helper)
    with pytest.raises(ValueError, match="no file"):
        reference.model("no_such_model")


@pytest.mark.parametrize("drop", ["model", "builder"])
def test_a_configuration_without_its_names_is_refused(tmp_path, drop):
    path = tmp_path / "flagship-bf16.json"
    path.write_text(json.dumps({k: v for k, v in CONFIGS["flagship-bf16"].items() if k != drop}))
    with pytest.raises(SystemExit, match=re.escape(f"{path}: no '{drop}' key")):
        harness.load_config(path)
    assert harness.load_config(ROOT / "gpubench/configs/flagship-bf16.json") \
        == CONFIGS["flagship-bf16"]


@pytest.mark.parametrize("path", [
    "birdnet_stm32_tpu.models.dscnn:build_dscnn",  # the JAX package
    "gpubench.reference.dscnn:scores",
    "os:getcwd",
    "birdnet_stm32_tpu_torch:build_dscnn",
    "birdnet_stm32_tpu_torch.models.dscnn",
    "birdnet_stm32_tpu_torch.models.dscnn:no_such_builder",
])
def test_a_builder_outside_the_port_is_refused(path):
    with pytest.raises(ValueError, match="builder"):
        system.builder(path)


def test_a_parameter_with_no_rule_asks_the_models_reference(monkeypatch):
    template = {"stem_conv.weight": torch.zeros(4, 1, 3, 3), "head.gain": torch.zeros(5)}
    config = {"model": "dscnn"}
    with pytest.raises(ValueError, match="no seeding rule for head.gain"):
        seeded_state(template, config, 3, "cpu")

    class Ref:
        @staticmethod
        def seeded(name, shape, z, u, config):
            return 1.0 + u if name == "head.gain" else None

    monkeypatch.setattr(reference, "model", lambda name: Ref)
    a = seeded_state(template, config, 3, "cpu")
    assert a["head.gain"].dtype == torch.float32
    assert ((a["head.gain"] >= 1.0) & (a["head.gain"] < 2.0)).all()
    torch.testing.assert_close(seeded_state(template, config, 3, "cpu"), a, rtol=0, atol=0)
    assert not torch.equal(seeded_state(template, config, 4, "cpu")["head.gain"], a["head.gain"])


# The stand-in's whole cell, run by a fresh interpreter inside the copy, so
# that the copy's gpubench/ is the one imported (the port comes from the
# repo through PYTHONPATH): the sound run, the run under the faults test's
# altered answer, and the MACs that mfu reads.
DRIVE = """
import importlib.util, json, time
import torch
from gpubench import harness
from gpubench.yardstick.macs import model_macs

torch.set_num_threads(1)
spec = importlib.util.spec_from_file_location("faults", "gpubench/tests/test_gpubench_faults.py")
faults = importlib.util.module_from_spec(spec)
spec.loader.exec_module(faults)


def run(wrap=None):
    return harness.run_cell("standin-b64-int16", 2**31 + 101, 0.3, False, time.perf_counter(),
                            devices=["cpu"], wrap=wrap, mix_update=faults.SMALL)


_, _, config, _ = harness.load_cell("standin-b64-int16")
# mfu over 1,000 chunks in one second on one card.
mfu = harness.read_metric("mfu", harness.TraceContext(None, 1, 4, 1, config, 1000, 1.0))
print(json.dumps({"harness": harness.__file__, "sound": run(), "altered": run(faults.altered_answer),
                  "macs": model_macs(config), "mfu": mfu,
                  "dscnn_macs": model_macs({**config, "model": "dscnn"})}))
"""


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_second_model_joins_as_new_files_only(tmp_path):
    config = json.loads((STANDIN / "config.json").read_text())
    with pytest.raises(ValueError, match="plain DS-CNN only"):
        dscnn.scores({}, torch.zeros(1, 257, 256, 1), config)

    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "gpubench")

    model, name, cell = config["model"], config["name"], "standin-b64-int16"
    shutil.copy(STANDIN / "config.json", tmp_path / f"gpubench/configs/{name}.json")
    shutil.copy(STANDIN / "reference.py", tmp_path / f"gpubench/reference/{model}.py")
    shutil.copy(STANDIN / "macs.py", tmp_path / f"gpubench/yardstick/macs_{model}.py")
    bench["configs"].append({"name": name, "source": config["source"],
                             "file": f"gpubench/configs/{name}.json", "reduced": [],
                             "why": "a stand-in second model"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": "closed-b64-int16",
                               "chips": 1, "why": "the stand-in under the flagship's traffic"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])

    assert Path(out["harness"]).resolve() == (tmp_path / "gpubench/harness.py").resolve()
    (sound, sound_checks), (broken, checks) = out["sound"], out["altered"]
    assert sound["correct"] is True and sound["failed"] == 0, sound_checks
    assert sound_checks["score_gap"]["limit"] == config["score_gap_limit"]
    assert broken["correct"] is False
    assert checks["score_gap"]["value"] > 4 * max(sound_checks["score_gap"]["value"],
                                                  config["score_gap_limit"])
    assert out["macs"] == load_file(STANDIN, "macs").model_macs(config) != out["dscnn_macs"]
    assert out["mfu"] == pytest.approx(100 * 2 * out["macs"] * 1000 / 67e12, rel=1e-12)

    after = _digests(tmp_path / "gpubench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {f"configs/{name}.json", f"reference/{model}.py",
                                        f"yardstick/macs_{model}.py"}
