"""PyTorch port, the `deploy` verb (cli/deploy.py) and the firmware headers
(deploy/headers.py) against the JAX package.

- app_config.h / app_labels.h: byte-equal to the JAX package's for the
  flagship and the nine fuzz configurations; mfcc and log_mel raise the same
  ValueError;
- build_bundle: the flagship bundle's files rebuilt by the port carry the
  sha256 and size of the committed artifacts/flagship/bundle/manifest.json,
  and every manifest equals the JAX build_bundle's for the same inputs (a
  .tflite, a run directory, the convert fixture);
- the verb: --dry_run's plan equal to JAX's, the label-count guard,
  --thresholds (explicit, picked up, missing), --stablehlo exit 2, the
  arguments and aliases equal to JAX's; validate_bundle on the CPU for a
  .tflite and for a run directory (the card's is chip_smoke.py's deploy
  phase and tests/test_torch_cuda.py).
"""

import contextlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from birdnet_stm32_tpu.cli import deploy as JDEP
from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.deploy import headers as JH
from birdnet_stm32_tpu_torch.__main__ import main as verb
from birdnet_stm32_tpu_torch.cli import deploy as PDEP
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.deploy import headers as PH
from birdnet_stm32_tpu_torch.models.runners import load_model_runner
from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
from tests.int8_fixture import FLAGSHIP_TFLITE
from tests.make_torch_convert_fixtures import OUT as CONVERT_DIR
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import N_CONFIGS
from tests.torch_fuzz_fixtures import load as load_fuzz
from tests.torch_train_fixtures import one_torch_thread, write_run_dir  # noqa: F401

warm_up()

BUNDLE = FLAGSHIP_TFLITE.parent
MANIFEST = json.loads((BUNDLE / "manifest.json").read_text())


def _configs():
    flagship = json.loads((BUNDLE / "model_config.json").read_text())
    return [("flagship", flagship)] + [(load_fuzz(i).label, load_fuzz(i).cfg)
                                       for i in range(N_CONFIGS)]


CONFIGS = _configs()


@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_headers_equal_jax(label, cfg, tmp_path):
    pcfg, jcfg = ModelConfig.from_dict(cfg), JaxModelConfig.from_dict(cfg)
    labels = [*cfg["class_names"], 'say "hi"\\']  # escaping
    assert PH.generate_app_labels_h(labels) == JH.generate_app_labels_h(labels)
    if cfg["audio_frontend"] in ("mfcc", "log_mel"):
        with pytest.raises(ValueError) as got:
            PH.generate_app_config_h(pcfg)
        with pytest.raises(ValueError) as ref:
            JH.generate_app_config_h(jcfg)
        assert str(got.value) == str(ref.value) and "no firmware mode" in str(got.value)
        return
    assert PH.generate_app_config_h(pcfg) == JH.generate_app_config_h(jcfg)
    got = PH.write_headers(pcfg, cfg["class_names"], tmp_path / "p")
    ref = JH.write_headers(jcfg, cfg["class_names"], tmp_path / "j")
    for a, b in zip(got, ref):
        assert a.name == b.name and a.read_bytes() == b.read_bytes()
    if label == "flagship":
        for p in got:
            assert PDEP._sha256(p) == MANIFEST["files"][f"firmware/{p.name}"]["sha256"]


def _build(mod, model, out, **kw):
    model = Path(model)
    cfg, labels = mod.derive_sidecar_paths(str(model))
    with contextlib.redirect_stdout(io.StringIO()) as log:
        manifest = mod.build_bundle(model, Path(cfg), Path(labels), out, **kw)
    return manifest, log.getvalue()


def test_flagship_bundle_reproduces_committed_manifest(tmp_path):
    """No JAX needed: the port's bundle of the committed .tflite, config and
    labels is the committed manifest (every sha256 and size), and the JAX
    build_bundle's manifest of the same inputs is the same dict."""
    got, _ = _build(PDEP, FLAGSHIP_TFLITE, tmp_path / "port")
    assert got == MANIFEST
    ref, _ = _build(JDEP, FLAGSHIP_TFLITE, tmp_path / "jax")
    assert got == ref
    for name, entry in got["files"].items():
        assert PDEP._sha256(tmp_path / "port" / name) == entry["sha256"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    run = tmp_path_factory.mktemp("deploy") / "run"
    write_run_dir(run, seed=2)
    return run


def test_run_directory_and_convert_fixture_bundles_equal_jax(run_dir, tmp_path):
    for name, model in (("run", run_dir), ("convert", CONVERT_DIR / "model_quantized.tflite")):
        got, got_log = _build(PDEP, model, tmp_path / name / "port")
        ref, ref_log = _build(JDEP, model, tmp_path / name / "jax")
        assert got == ref
        assert got_log.replace("port", "X") == ref_log.replace("jax", "X")
    # The convert fixture has the flagship's sidecars: the same headers.
    conv = json.loads((tmp_path / "convert" / "port" / "manifest.json").read_text())
    for name in ("model_config.json", "labels.txt", "firmware/app_config.h",
                 "firmware/app_labels.h"):
        assert conv["files"][name] == MANIFEST["files"][name], name
    tflite = CONVERT_DIR / "model_quantized.tflite"
    assert conv["files"][tflite.name] == {"sha256": PDEP._sha256(tflite),
                                          "bytes": tflite.stat().st_size}


def _run(mod, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = mod.main(argv)
    return rc, out.getvalue()


def test_dry_run_equals_jax(tmp_path):
    argv = ["--model_path", str(FLAGSHIP_TFLITE), "--output_dir", str(tmp_path / "b"),
            "--dry_run"]
    got, ref = _run(PDEP, argv), _run(JDEP, argv)
    assert got == ref and got[0] == 0
    assert "dry run" in got[1] and "app_config.h + app_labels.h" in got[1]
    assert not (tmp_path / "b").exists()


def test_label_count_guard_and_thresholds(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\n")
    for mod in (PDEP, JDEP):
        with pytest.raises(SystemExit, match="refusing to generate mismatched"):
            mod.build_bundle(FLAGSHIP_TFLITE, BUNDLE / "model_config.json", labels,
                             tmp_path / "x", dry_run=True)
    # Explicit thresholds are shipped; a missing explicit file exits.
    th = tmp_path / "th.json"
    th.write_text(json.dumps({"a": 0.3}))
    rc, _ = _run(PDEP, ["--model_path", str(FLAGSHIP_TFLITE), "--output_dir",
                        str(tmp_path / "t"), "--thresholds", str(th), "--skip_validate"])
    assert rc == 0 and (tmp_path / "t" / "thresholds.json").read_text() == th.read_text()
    manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert manifest["files"]["thresholds.json"]["sha256"] == PDEP._sha256(th)
    with pytest.raises(SystemExit, match="--thresholds not found"):
        _run(PDEP, ["--model_path", str(FLAGSHIP_TFLITE), "--output_dir",
                    str(tmp_path / "u"), "--thresholds", str(tmp_path / "none.json")])
    # thresholds.json next to the model is picked up.
    src = tmp_path / "src"
    shutil.copytree(BUNDLE, src)
    (src / "thresholds.json").write_text("{}")
    got, _ = _build(PDEP, src / FLAGSHIP_TFLITE.name, tmp_path / "v")
    ref, _ = _build(JDEP, src / FLAGSHIP_TFLITE.name, tmp_path / "w")
    assert "thresholds.json" in got["files"] and got == ref


def test_verb_errors(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no default deploy config here
    assert verb(["deploy", "--model_path", str(FLAGSHIP_TFLITE), "--stablehlo"]) == 2
    assert "Queue 1 item 5" in capsys.readouterr().err
    assert verb(["deploy"]) == 1  # no model
    assert verb(["deploy", "--model_path", str(tmp_path / "none.tflite")]) == 1
    assert verb(["deploy", "--config", str(tmp_path / "none.toml")]) == 1
    lone = tmp_path / "lone.tflite"  # no config beside it
    shutil.copy(FLAGSHIP_TFLITE, lone)
    assert verb(["deploy", "--model_path", str(lone)]) == 1
    out = capsys.readouterr().out
    for line in ("no model", "does not exist", "config file not found",
                 "missing required files"):
        assert line in out, line


def test_verb_arguments_match_jax():
    argv = ["--model", "m.tflite", "--model_config", "c.json", "--labels", "l.txt",
            "--output_dir", "o", "--config", "d.toml", "--thresholds", "t.json",
            "--dry_run", "--skip_validate", "--stablehlo", "--stedgeai_path", "s",
            "--x_cube_ai_path", "x", "--cubeide_path", "c", "--arm_toolchain_path", "a",
            "--workspace_dir", "w", "--n6_loader_config", "n"]
    got, ref = vars(PDEP.get_args(argv)), vars(JDEP.get_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref


def test_deploy_and_validate_on_cpu(run_dir, tmp_path):
    """The verb end to end with --device cpu on a .tflite and on a run
    directory: the bundle validates (one batch through load_model_runner
    and make_fused_classifier), and the deployed .tflite classifies
    bit-equal to its source."""
    for model, out in ((FLAGSHIP_TFLITE, tmp_path / "tflite"), (run_dir, tmp_path / "run")):
        rc, log = _run(PDEP, ["--model_path", str(model), "--output_dir", str(out),
                              "--device", "cpu"])
        assert rc == 0 and "validate OK: (8, " in log and "[deploy] done" in log
        result = PDEP.validate_bundle(out, Path(model).name, batch_size=3, device="cpu")
        cfg = ModelConfig.load(out / "model_config.json")
        assert result["output_shape"] == [3, cfg.num_classes]
    cfg = ModelConfig.load(BUNDLE / "model_config.json")
    wave = np.random.default_rng(0).normal(0, 0.1, (2, cfg.chunk_samples)).astype(np.float32)
    scores = [make_fused_classifier(load_model_runner(p, device="cpu"), cfg, device="cpu")(wave)
              for p in (FLAGSHIP_TFLITE, tmp_path / "tflite" / FLAGSHIP_TFLITE.name)]
    np.testing.assert_array_equal(*scores)
    assert (tmp_path / "run" / "run" / "best" / "state_dict.pt").exists()
