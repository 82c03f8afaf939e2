"""PyTorch port, the `evaluate`, `benchmark`, `board-test` and `profile`
verbs (`python -m birdnet_stm32_tpu_torch ...`, run in process with
--device cpu), the deploy config (deploy/config.py), the frontend registry
and the analytical profiler, against the JAX package where it has a
counterpart.

The verbs run on a run directory of the port's format holding Flax weights
(tests/torch_train_fixtures.py::write_run_dir) over seeded 4 kHz WAVs, and
on a copy of the committed flagship bundle (a trained 100-class INT8 graph
whose pooled scores vary, 0.07-0.98 per file) over seeded 22.05 kHz WAVs
of three of its classes. Checks: the output protocol lines and the report
files; evaluate's predictions CSV equal to the API's pooled scores at its 3
decimals; benchmark's and board-test's per-file top-1 and score equal to
the API's (classify_in_batches over each whole file, mean-pooled), and the
pipelined driver's to the serial one's within 1e-5; each of these score
gates fails on a constant and on a class-shuffled score vector (the
*_gate_bites tests); the int16 / mu-law exclusion; the deploy
config's precedence cases of the JAX package's tests; profile_model,
totals and check_n6_compatibility equal to the JAX package's for the
flagship and the nine fuzz configs, and the parameter count equal to the
port's DS-CNN's.
"""

import contextlib
import csv
import dataclasses
import io
import json
import shutil

import numpy as np
import pytest

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.deploy import config as JD
from birdnet_stm32_tpu.models import profiler as JPROF
from birdnet_stm32_tpu.models import registry as JREG
from birdnet_stm32_tpu_torch import __main__ as PMAIN
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.deploy import config as PD
from birdnet_stm32_tpu_torch.evaluation import metrics as PM
from birdnet_stm32_tpu_torch.models import profiler as PPROF
from birdnet_stm32_tpu_torch.models import registry as PREG
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.models.runners import load_model_runner
from tests.int8_fixture import FLAGSHIP_TFLITE
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import N_CONFIGS, bad_outputs
from tests.torch_fuzz_fixtures import load as load_fuzz
from tests.torch_train_fixtures import one_torch_thread, write_run_dir  # noqa: F401
from tests.torch_train_fixtures import write_wav_folder

warm_up()

FLAGSHIP_CLASSES = json.loads((FLAGSHIP_TFLITE.parent / "model_config.json")
                              .read_text())["class_names"]


def run(*argv) -> tuple[int, str]:
    """The port's CLI in this process: (exit code, standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = PMAIN.main(list(argv))
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_evaluate")
    data = write_wav_folder(root / "data", files_per_class=2, seed=3)
    data22 = write_wav_folder(root / "data22", sample_rate=22050,
                              classes=FLAGSHIP_CLASSES[:3], files_per_class=2, seed=3)
    write_run_dir(root / "run", seed=1)
    shutil.copytree(FLAGSHIP_TFLITE.parent, root / "flagship")
    return {"root": root, "data": {"run": data, "tflite": data22}, "run": root / "run",
            "tflite": root / "flagship" / FLAGSHIP_TFLITE.name}


def _model(model: str) -> str:
    return "tflite" if model == "tflite" else "run"


def _api_pooled(assets, model: str) -> tuple[list, list, np.ndarray]:
    """(files, classes, [F, C] pooled scores) through the API: each whole
    file's chunks through the fused classifier, mean-pooled (the benchmark
    and board-test loop). Computed once per model."""
    key = ("pooled", model)
    if key not in assets:
        assets[key] = _pool(assets, model)
    return assets[key]


def _pool(assets, model: str):
    from birdnet_stm32_tpu_torch.models.serving import (
        classify_in_batches,
        decode_for_classify,
        make_fused_classifier,
    )

    path = assets[model]
    cfg = ModelConfig.load((path if path.is_dir() else path.parent) / "model_config.json")
    classify = make_fused_classifier(load_model_runner(path, device="cpu"), cfg, device="cpu")
    files = sorted(str(p) for p in assets["data"][model].rglob("*.wav"))
    pooled = [classify_in_batches(classify, decode_for_classify(f, cfg)[0], 8)[0].mean(axis=0)
              for f in files]
    return files, cfg.class_names, np.stack(pooled)


def _top1_match(rows, files, classes, pooled, atol: float) -> bool:
    """A driver's per-file (top1, score) rows against the API's pooled
    scores: the same file order, top-1 label and score within atol."""
    from birdnet_stm32_tpu_torch.models.serving import top_predictions

    if [r[0] for r in rows] != files:
        return False
    for (_, top1, score), p in zip(rows, pooled):
        i = top_predictions(p, 1, 0.0)[0]
        if top1 != classes[i] or abs(float(score) - float(p[i])) > atol:
            return False
    return True


EVAL_FLAGS = ["--device", "cpu", "--batch_size", "8", "--optimize_thresholds", "--bootstrap_ci",
              "--n_bootstrap", "20", "--det_curve", "--benchmark_latency", "--profile_memory",
              "--save_csv", "--save_benchmark_json", "--save_html"]


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("model", ["run", "run_bf16", "tflite"])
def test_evaluate_cli_reports(assets, tmp_path, model):
    path = assets[_model(model)]
    extra = ["--bf16"] if model == "run_bf16" else []
    rc, out = run("evaluate", "--model_path", str(path), "--data_path_test",
                  str(assets["data"][_model(model)]),
                  "--output_dir", str(tmp_path), "--species_report", str(tmp_path / "sp.csv"),
                  "--save_embeddings", str(tmp_path / "emb.npz"), *EVAL_FLAGS, *extra)
    assert rc == 0
    for line in ("=== Evaluation ===", "roc-auc:", "cmAP:", "total_chunks:", "latency_p99_ms:",
                 "peak_rss_mb:", "Confusion Matrix", "ASCII Precision-Recall Curve",
                 "ASCII DET Curve", "@optimized thresholds", "HTML report ->"):
        assert line in out, line
    for name in ("thresholds.json", "predictions.csv", "species_report.csv", "benchmark.json",
                 "report.html", "sp.csv"):
        assert (tmp_path / name).stat().st_size > 0, name
    report = json.loads((tmp_path / "benchmark.json").read_text())
    assert report["num_files"] == 6 and report["metrics"]["total_chunks"] > 0
    classes = FLAGSHIP_CLASSES if model == "tflite" else ["a", "b", "c"]
    assert set(json.loads((tmp_path / "thresholds.json").read_text())) <= set(classes)
    # The predictions CSV holds the API's pooled scores at 3 decimals.
    cfg = ModelConfig.load((path if path.is_dir() else path.parent) / "model_config.json")
    import torch

    runner = load_model_runner(path, dtype=torch.bfloat16 if extra else None, device="cpu")
    files = sorted(str(p) for p in assets["data"][_model(model)].rglob("*.wav"))
    _, per_file, _, _ = PM.evaluate(runner, files, cfg.class_names, cfg, batch_size=8,
                                    device="cpu")
    rows = list(csv.reader(open(tmp_path / "predictions.csv")))
    assert rows[0][:4] == ["file", "label", "top1_label", "top1_score"]
    scores = np.array([r["scores"] for r in per_file])
    assert _predictions_match(rows[1:], [r["file"] for r in per_file], scores)
    if model == "tflite":
        assert np.ptp(scores, axis=1).min() > 4 / 256  # scores that vary
    if model == "tflite":
        assert "--save_embeddings skipped" in out and not (tmp_path / "emb.npz").exists()
    else:
        emb = np.load(tmp_path / "emb.npz")
        assert emb["embeddings"].shape == (6, 32) and np.isfinite(emb["embeddings"]).all()


def _predictions_match(rows, files, scores) -> bool:
    """evaluate's predictions CSV rows against the API's pooled scores at
    the CSV's 3 decimals."""
    return [r[0] for r in rows] == files and all(
        np.array_equal([float(v) for v in row[4:]], [float(f"{s:.3f}") for s in ref])
        for row, ref in zip(rows, scores))


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("variant", ["constant", "shuffled"])
def test_evaluate_cli_gate_bites(assets, tmp_path, variant):
    """The predictions-CSV gate fails when the API's scores are replaced by
    a constant or a class-shuffled vector (the flagship bundle)."""
    rc, _ = run("evaluate", "--model_path", str(assets["tflite"]), "--data_path_test",
                str(assets["data"]["tflite"]), "--output_dir", str(tmp_path), "--device", "cpu",
                "--batch_size", "8", "--save_csv")
    assert rc == 0
    cfg = ModelConfig.load(assets["tflite"].parent / "model_config.json")
    files = sorted(str(p) for p in assets["data"]["tflite"].rglob("*.wav"))
    _, per_file, _, _ = PM.evaluate(load_model_runner(assets["tflite"], device="cpu"), files,
                                    cfg.class_names, cfg, batch_size=8, device="cpu")
    rows = list(csv.reader(open(tmp_path / "predictions.csv")))[1:]
    names = [r["file"] for r in per_file]
    scores = np.array([r["scores"] for r in per_file])
    assert _predictions_match(rows, names, scores)
    assert not _predictions_match(rows, names, bad_outputs(scores)[variant])


def test_evaluate_guards(assets, tmp_path):
    """--int16_io with --ulaw_io exits before any load (the model path does
    not exist); a directory with no class folder of the model's exits, and
    one with only noise files besides raises, as in the JAX package."""
    with pytest.raises(SystemExit, match="mutually exclusive"):
        run("evaluate", "--model_path", str(tmp_path / "missing.tflite"), "--data_path_test",
            str(tmp_path), "--int16_io", "--ulaw_io", "--device", "cpu")
    other = write_wav_folder(tmp_path / "other", classes=("zz",), files_per_class=1)
    with pytest.raises(RuntimeError, match="No valid test samples"):
        run("evaluate", "--model_path", str(assets["run"]), "--data_path_test", str(other),
            "--device", "cpu")
    (other / "noise" / "noise_0.wav").unlink()
    with pytest.raises(SystemExit, match="matches the model's classes"):
        run("evaluate", "--model_path", str(assets["run"]), "--data_path_test", str(other),
            "--device", "cpu")
    with pytest.raises(SystemExit):
        run("evaluate", "--model_path", str(assets["run"]))  # no --data_path_test


def _bench(assets, model, csv_path, *extra):
    rc, out = run("benchmark", "--model_path", str(assets[model]), "--audio_dir",
                  str(assets["data"][model]), "--device", "cpu", "--batch_size", "8", "--csv",
                  str(csv_path), *extra)
    assert rc == 0
    return out, list(csv.DictReader(open(csv_path)))


def _bench_rows(rows):
    return [(r["file"], r["top1"], r["score"]) for r in rows]


@pytest.mark.parametrize("model", ["run", "tflite"])
def test_benchmark_serial_and_pipelined(assets, tmp_path, model):
    serial_out, serial = _bench(assets, model, tmp_path / "s.csv")
    piped_out, piped = _bench(assets, model, tmp_path / "p.csv", "--pipeline", "2")
    for out in (serial_out, piped_out):
        assert out.count("[BENCH] read:") == 8  # every file decodes
        assert "=== DONE ===" in out and "real-time factor:" in out
        assert "files: 8  chunks:" in out
    assert [r["file"] for r in serial] == [r["file"] for r in piped]
    assert [r["top1"] for r in serial] == [r["top1"] for r in piped]
    np.testing.assert_allclose([float(r["score"]) for r in piped],
                               [float(r["score"]) for r in serial], rtol=0, atol=1e-5)
    # Both drivers' top-1 and score against the API's pooled scores.
    files, classes, pooled = _api_pooled(assets, model)
    for rows in (serial, piped):
        assert _top1_match(_bench_rows(rows), files, classes, pooled, 1e-5)


@pytest.mark.parametrize("variant", ["constant", "shuffled"])
def test_benchmark_gate_bites(assets, tmp_path, variant):
    """The top-1 gate fails on a constant or class-shuffled pooled vector in
    place of the API's (the flagship bundle)."""
    _, serial = _bench(assets, "tflite", tmp_path / "s.csv")
    files, classes, pooled = _api_pooled(assets, "tflite")
    assert np.ptp(pooled, axis=1).min() > 4 / 256  # scores that vary
    assert _top1_match(_bench_rows(serial), files, classes, pooled, 1e-5)
    assert not _top1_match(_bench_rows(serial), files, classes, bad_outputs(pooled)[variant],
                           1e-5)


def test_benchmark_modes_and_trace(assets, tmp_path):
    for extra in (["--int16_io"], ["--ulaw_io"], ["--device_resample"]):
        out, rows = _bench(assets, "tflite", tmp_path / "m.csv", *extra)
        assert out.count("[BENCH] read:") == 8 and len(rows) == 8
    out, _ = _bench(assets, "tflite", tmp_path / "t.csv", "--trace_dir", str(tmp_path / "tr"))
    trace = json.loads((tmp_path / "tr" / "benchmark_trace.json").read_text())
    assert trace["traceEvents"] and "profiler trace ->" in out
    spans = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"serve.request", "serve.ingress", "serve.frontend", "serve.model",
            "serve.egress", "tflite.CONV_2D"} <= spans
    with pytest.raises(SystemExit, match="mutually exclusive"):
        run("benchmark", "--model_path", str(tmp_path / "missing"), "--audio_dir",
            str(tmp_path), "--int16_io", "--ulaw_io")


@pytest.mark.parametrize("fmt", ["toml", "json"])
def test_board_test_from_deploy_config(assets, tmp_path, fmt):
    if fmt == "toml":
        cfg = tmp_path / "deploy.toml"
        cfg.write_text(f'top_k = 2\n[serving]\nmodel_path = "{assets["tflite"]}"\n'
                       f'audio_dir = "{assets["data"]["tflite"]}"\nbatch_size = 8\n')
    else:
        cfg = tmp_path / "deploy.json"
        cfg.write_text(json.dumps({"model_path": str(assets["tflite"]),
                                   "audio_dir": str(assets["data"]["tflite"]),
                                   "batch_size": 8}))
    rc, out = run("board-test", "--config", str(cfg), "--device", "cpu",
                  "--save_results", str(tmp_path / "r.csv"))
    assert rc == 0 and "=== DONE ===" in out and out.count("[BENCH] read:") == 8
    rows = list(csv.reader(open(tmp_path / "r.csv")))
    assert rows[0] == ["file", "top_label", "top_score"] and len(rows) == 9
    # Its top label and 4-decimal score against the API's pooled scores.
    files, classes, pooled = _api_pooled(assets, "tflite")
    assert _top1_match(rows[1:], files, classes, pooled, BOARD_SCORE_ATOL)


# board-test writes its scores at 4 decimals.
BOARD_SCORE_ATOL = 5e-5 + 1e-7


@pytest.mark.parametrize("variant", ["constant", "shuffled"])
def test_board_test_gate_bites(assets, tmp_path, monkeypatch, variant):
    """The board-test CSV gate fails on a constant or class-shuffled pooled
    vector in place of the API's (the flagship bundle)."""
    monkeypatch.chdir(tmp_path)
    rc, _ = run("board-test", "--model_path", str(assets["tflite"]), "--audio_dir",
                str(assets["data"]["tflite"]), "--batch_size", "8", "--device", "cpu",
                "--save_results", str(tmp_path / "r.csv"))
    assert rc == 0
    rows = list(csv.reader(open(tmp_path / "r.csv")))[1:]
    files, classes, pooled = _api_pooled(assets, "tflite")
    assert _top1_match(rows, files, classes, pooled, BOARD_SCORE_ATOL)
    assert not _top1_match(rows, files, classes, bad_outputs(pooled)[variant], BOARD_SCORE_ATOL)


def test_board_test_errors(assets, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no default deploy config here
    assert run("board-test", "--device", "cpu")[0] == 1  # no model
    assert run("board-test", "--model_path", str(assets["tflite"]), "--device", "cpu")[0] == 1
    assert run("board-test", "--config", str(tmp_path / "none.toml"), "--device", "cpu")[0] == 1
    monkeypatch.setenv("BIRDNET_TPU_AUDIO_DIR", str(assets["data"]["tflite"]))
    rc, out = run("board-test", "--model_path", str(assets["tflite"]), "--device", "cpu",
                  "--batch_size", "8", "--top_k", "1")
    assert rc == 0 and out.count("[BENCH] read:") == 8


# --- deploy config: the JAX package's precedence cases --------------------

def _defaults(mod, tmp_path, monkeypatch):
    cfg = mod.resolve_deploy_config(search_dir="/nonexistent_dir_xyz")
    assert (cfg.batch_size, cfg.top_k, cfg.use_int8) == (64, 3, True)
    return cfg


def _json_file(mod, tmp_path, monkeypatch):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"batch_size": 128, "top_k": 5, "custom_key": "x"}))
    cfg = mod.resolve_deploy_config(config_file=p)
    assert (cfg.batch_size, cfg.top_k, cfg.extra) == (128, 5, {"custom_key": "x"})
    return cfg


def _toml_serving_table(mod, tmp_path, monkeypatch):
    p = tmp_path / "c.toml"
    p.write_text('top_k = 4\n[serving]\nbatch_size = 256\nuse_int8 = false\n')
    cfg = mod.resolve_deploy_config(config_file=p)
    assert (cfg.batch_size, cfg.top_k, cfg.use_int8) == (256, 4, False)
    return cfg


def _cross_format(mod, tmp_path, monkeypatch):
    p = tmp_path / "c.toml"
    p.write_text(json.dumps({"batch_size": 32, "chunk_overlap": "0.5"}))
    cfg = mod.resolve_deploy_config(config_file=p)
    assert (cfg.batch_size, cfg.chunk_overlap) == (32, 0.5)
    return cfg


def _env_over_file(mod, tmp_path, monkeypatch):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"batch_size": 128}))
    monkeypatch.setenv("BIRDNET_TPU_BATCH_SIZE", "16")
    monkeypatch.setenv("BIRDNET_TPU_USE_INT8", "false")
    cfg = mod.resolve_deploy_config(config_file=p)
    assert (cfg.batch_size, cfg.use_int8) == (16, False)
    return cfg


def _cli_over_env(mod, tmp_path, monkeypatch):
    monkeypatch.setenv("BIRDNET_TPU_TOP_K", "9")
    cfg = mod.resolve_deploy_config(cli_values={"top_k": 2, "batch_size": None},
                                    search_dir=str(tmp_path))
    assert (cfg.top_k, cfg.batch_size) == (2, 64)  # None CLI values are ignored
    return cfg


def _default_file_search(mod, tmp_path, monkeypatch):
    (tmp_path / "birdnet_tpu.json").write_text(json.dumps({"top_k": 7}))
    cfg = mod.resolve_deploy_config(search_dir=tmp_path)
    assert cfg.top_k == 7
    return cfg


def _validation(mod, tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        mod.resolve_deploy_config(cli_values={"batch_size": 0}, search_dir="/none")
    with pytest.raises(FileNotFoundError):
        mod.resolve_deploy_config(cli_values={"model_path": "/no/such/model"}, search_dir="/none")
    with pytest.raises(FileNotFoundError):
        mod.resolve_deploy_config(config_file="/no/such/config.json")
    with pytest.raises(ValueError, match="cannot interpret"):
        monkeypatch.setenv("BIRDNET_TPU_TOP_K", "many")
        mod.resolve_deploy_config(search_dir="/none")
    monkeypatch.delenv("BIRDNET_TPU_TOP_K")
    mod.DeployConfig(batch_size=8).validate()
    with pytest.raises(ValueError):
        mod.DeployConfig(top_k=0).validate()
    return mod.DeployConfig(batch_size=8)


DEPLOY_CASES = [_defaults, _json_file, _toml_serving_table, _cross_format, _env_over_file,
                _cli_over_env, _default_file_search, _validation]


@pytest.mark.parametrize("case", DEPLOY_CASES, ids=lambda f: f.__name__.strip("_"))
def test_deploy_config_precedence_matches_jax(case, tmp_path, monkeypatch):
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    got = case(PD, tmp_path / "port", monkeypatch)
    ref = case(JD, tmp_path / "jax", monkeypatch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert PD.ENV_PREFIX == JD.ENV_PREFIX and PD.DEFAULT_CONFIG_NAMES == JD.DEFAULT_CONFIG_NAMES


# --- profiler, registry, profile verb ------------------------------------

def _configs():
    """(label, config dict, head) of the flagship and the nine fuzz configs."""
    flagship = json.loads((FLAGSHIP_TFLITE.parent / "model_config.json").read_text())
    out = [("flagship", flagship, "softmax")]
    for i in range(N_CONFIGS):
        fx = load_fuzz(i)
        out.append((fx.label, fx.cfg, fx.class_activation))
    return out


CONFIGS = _configs()


@pytest.mark.parametrize("label,cfg,head", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_profiler_matches_jax_and_the_model(label, cfg, head):
    rows = PPROF.profile_model(ModelConfig.from_dict(cfg))
    ref = JPROF.profile_model(JaxModelConfig.from_dict(cfg))
    assert [dataclasses.astuple(r) for r in rows] == [dataclasses.astuple(r) for r in ref]
    assert PPROF.totals(rows) == JPROF.totals(ref)
    assert PPROF.check_n6_compatibility(ModelConfig.from_dict(cfg)) == \
        JPROF.check_n6_compatibility(JaxModelConfig.from_dict(cfg))
    model = build_dscnn(ModelConfig.from_dict(cfg), class_activation=head, device="cpu")
    assert PPROF.totals(rows)["params"] == sum(p.numel() for p in model.parameters())


def test_profile_verb_and_registry(assets, tmp_path):
    rc, out = run("profile", "--config_path", str(FLAGSHIP_TFLITE.parent / "model_config.json"))
    assert rc == 0 and "Total params: 224,388" in out
    rc, out = run("profile", "--model_path", str(assets["run"]))
    cfg = ModelConfig.load(assets["run"] / "model_config.json")
    assert rc == 0 and f"Total params: {PPROF.totals(PPROF.profile_model(cfg))['params']:,}" in out
    with pytest.raises(SystemExit, match="need --config_path"):
        run("profile")
    assert PREG.registered_frontends() == JREG.registered_frontends()
    for name in PREG.list_frontends():
        assert dataclasses.asdict(PREG.get_frontend_info(name)) == \
            dataclasses.asdict(JREG.get_frontend_info(name))
        assert PREG.is_precomputed(name) == JREG.is_precomputed(name)
    with pytest.raises(ValueError, match="already registered"):
        PREG.register_frontend(PREG.get_frontend_info("hybrid"))
    with pytest.raises(KeyError):
        PREG.get_frontend_info("nope")


def test_verbs_registered():
    for verb in ("serve", "train", "evaluate", "benchmark", "board-test", "profile",
                 "convert", "deploy"):
        assert verb in PMAIN.COMMANDS
    assert PMAIN.main(["nope"]) == 2
    rc, out = run("--help")
    assert rc == 0 and all(verb in out for verb in PMAIN.COMMANDS)
