"""PyTorch port, the serve CLI (`python -m birdnet_stm32_tpu_torch serve`)
on the committed INT8 bundle, and load_model_runner.

The CLI runs on the CPU here (--device cpu). Its per-file pooled scores
are held against the JAX serving pipeline on the same files
(decode_for_classify -> make_fused_classifier over a TFLiteSimRunner ->
classify_in_batches -> mean) at cosine >= 0.999 per file, the gate the
port holds its INT8 classify to (tests/test_torch_int8_entry.py): the JAX
pipeline feeds the executor from its XLA composition, the port from its
kernel's plain version, which can move an entry code next to a rounding
tie. The TSV keeps 4 decimals.
"""

import functools
import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models import runners as JR
from birdnet_stm32_tpu.models import serving as J
from birdnet_stm32_tpu.quant.tflite_import import TFLiteGraph as JTFLiteGraph
from birdnet_stm32_tpu_torch.__main__ import main
from birdnet_stm32_tpu_torch.audio.io import save_wav
from birdnet_stm32_tpu_torch.cli.deploy import derive_sidecar_paths, resolve_config_path
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models import runners as PR
from birdnet_stm32_tpu_torch.models.serving import decode_for_classify, make_fused_classifier
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
from tests.int8_fixture import FLAGSHIP_TFLITE, flagship_features
from tests.test_torch_cpu_warmup import warm_up

warm_up()

REPO = Path(__file__).resolve().parents[1]
BUNDLE_CONFIG = FLAGSHIP_TFLITE.parent / "model_config.json"
SR = 22050
MODES = {"float": [], "int16": ["--int16_io"], "ulaw": ["--ulaw_io"],
         "device_resample": ["--device_resample"]}


def _chirp(seed: int, seconds: float, sr: int, channels: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(800.0, 5000.0)
    x = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.3 * t))[:, None]
    return (x + rng.normal(0, 0.05, (t.size, channels))).astype(np.float32)


def _write_stereo(path: Path, x: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _make_audio_dir(root: Path) -> Path:
    """Mono PCM16 at the model rate (3 s and 4.5 s), stereo at the model
    rate, mono at 16 kHz; in two class folders."""
    save_wav(_chirp(0, 3.0, SR)[:, 0], root / "a" / "one.wav", SR)
    save_wav(_chirp(1, 4.5, SR)[:, 0], root / "a" / "two.wav", SR)
    (root / "b").mkdir(parents=True)
    _write_stereo(root / "b" / "stereo.wav", _chirp(2, 3.0, SR, 2), SR)
    save_wav(_chirp(3, 3.2, 16000)[:, 0], root / "b" / "rate16k.wav", 16000)
    return root


def _serve_args(audio_dir, results, *extra):
    return ["serve", "--model_path", str(FLAGSHIP_TFLITE), "--audio_dir", str(audio_dir),
            "--results_file", str(results), "--batch_size", "4", "--once", "--device", "cpu",
            *extra]


def _rows(results: Path) -> dict[str, np.ndarray]:
    rows = {}
    for line in results.read_text().splitlines():
        if line:
            k, *vals = line.split("\t")
            rows[k] = np.array([float(v) for v in vals])
    return rows


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The audio directory and the TSV of each mode, the float mode through
    `python -m`, the others in-process."""
    tmp = tmp_path_factory.mktemp("serve")
    audio_dir = _make_audio_dir(tmp / "audio")
    results = {m: tmp / f"{m}.txt" for m in MODES}
    proc = subprocess.run([sys.executable, "-m", "birdnet_stm32_tpu_torch",
                           *_serve_args(audio_dir, results["float"])],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "=== DONE ===" in proc.stdout and "files served: 4" in proc.stdout
    for mode, extra in MODES.items():
        if mode != "float":
            assert main(_serve_args(audio_dir, results[mode], *extra)) == 0
    return audio_dir, results


@functools.lru_cache(maxsize=None)
def _jax_classifier_cache(input_dtype):
    runner = JR.TFLiteSimRunner(str(FLAGSHIP_TFLITE))
    return J.make_classifier_cache(runner, JaxModelConfig.load(BUNDLE_CONFIG),
                                   input_dtype=input_dtype)


def _jax_pooled(path: Path, mode: str) -> np.ndarray:
    """The JAX serving pipeline's pooled scores of one file."""
    cfg = JaxModelConfig.load(BUNDLE_CONFIG)
    chunks, rate, _, _ = J.decode_for_classify(
        path, cfg, device_resample=mode == "device_resample",
        int16_io=mode == "int16", ulaw_io=mode == "ulaw")
    classify = _jax_classifier_cache({"int16": "int16", "ulaw": "ulaw"}.get(mode))(rate)
    scores, _ = J.classify_in_batches(classify, chunks, 4)
    return scores.mean(axis=0)


def _cosine(a, b) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_tsv_schema(served):
    audio_dir, results = served
    cfg = ModelConfig.load(BUNDLE_CONFIG)
    for mode, path in results.items():
        lines = [line for line in path.read_text().splitlines() if line]
        assert sorted(line.split("\t", 1)[0] for line in lines) == [
            "a/one.wav", "a/two.wav", "b/rate16k.wav", "b/stereo.wav"], mode
        for line in lines:
            cols = line.split("\t")
            assert len(cols) == 1 + cfg.num_classes
            assert all(len(c.split(".")[1]) == 4 for c in cols[1:])  # 4 decimals
            vals = np.array([float(c) for c in cols[1:]])
            assert np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_pooled_scores_match_jax_pipeline(served, mode):
    audio_dir, results = served
    rows = _rows(results[mode])
    for rel, got in rows.items():
        ref = _jax_pooled(audio_dir / rel, mode)
        assert _cosine(got, ref) >= 0.999, (mode, rel)
        np.testing.assert_allclose(got, ref, atol=0.02, err_msg=f"{mode} {rel}")


def test_int16_equals_float_on_raw_pcm16(served):
    """The mono PCM16 files at the model rate ship raw codes: their int16
    rows equal the float rows exactly."""
    _, results = served
    f, i = _rows(results["float"]), _rows(results["int16"])
    for rel in ("a/one.wav", "a/two.wav"):
        np.testing.assert_array_equal(i[rel], f[rel])


def test_resume_and_same_basename(tmp_path, capsys):
    audio_dir = tmp_path / "audio"
    save_wav(_chirp(4, 3.0, SR)[:, 0], audio_dir / "a" / "x.wav", SR)
    results = tmp_path / "results.txt"
    assert main(_serve_args(audio_dir, results)) == 0
    assert "files served: 1" in capsys.readouterr().out
    assert main(_serve_args(audio_dir, results)) == 0
    out = capsys.readouterr().out
    assert "resuming: 1 files" in out and "files served: 0" in out
    # The same file name in another folder is another file.
    save_wav(_chirp(5, 3.0, SR)[:, 0], audio_dir / "b" / "x.wav", SR)
    save_wav(_chirp(6, 3.0, SR)[:, 0], audio_dir / "a" / "late.wav", SR)
    (audio_dir / "a" / "garbage.wav").write_bytes(b"RIFFnope" * 5)
    assert main(_serve_args(audio_dir, results)) == 0
    out = capsys.readouterr().out
    assert "files served: 2" in out and "garbage.wav: no audio; skipped" in out
    keys = [line.split("\t", 1)[0] for line in results.read_text().splitlines() if line]
    assert sorted(keys) == ["a/late.wav", "a/x.wav", "b/x.wav"]


def test_decode_threads_match_serial(served, tmp_path, capsys):
    audio_dir, results = served
    threaded = tmp_path / "threaded.txt"
    assert main(_serve_args(audio_dir, threaded, "--int16_io", "--decode_threads", "2")) == 0
    capsys.readouterr()
    assert threaded.read_text() == results["int16"].read_text()


def test_thresholds(served, tmp_path, capsys):
    audio_dir, _ = served
    cfg = ModelConfig.load(BUNDLE_CONFIG)
    th = tmp_path / "th.json"
    th.write_text(json.dumps({cfg.class_names[0]: 0.999, cfg.class_names[1]: 0.0}))
    assert main(_serve_args(audio_dir, tmp_path / "r.txt", "--thresholds", str(th))) == 0
    assert "=== DONE ===" in capsys.readouterr().out
    # A labels file longer than the model's output: the vector keeps the
    # score width.
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join([*cfg.class_names, "zz_extra"]) + "\n")
    th.write_text(json.dumps({cfg.class_names[0]: 0.2, "zz_extra": 0.9}))
    assert main(_serve_args(audio_dir, tmp_path / "r2.txt", "--thresholds", str(th),
                            "--labels_path", str(labels))) == 0
    capsys.readouterr()
    th.write_text(json.dumps({"not_a_class": 0.5}))
    with pytest.raises(SystemExit, match="classes the model doesn't serve"):
        main(_serve_args(audio_dir, tmp_path / "r3.txt", "--thresholds", str(th)))


def test_guards(tmp_path, monkeypatch):
    """The int16 / mu-law mutual exclusion in the CLI and in
    decode_for_classify; --bf16 with a .tflite is accepted and ignored, as
    in the JAX package (the same TSV as without it); an unknown verb exits
    2, the verbs with a required flag (`train`, `evaluate`, `benchmark`,
    `convert`) exit 2 through argparse when it is missing, and `deploy`
    without a model exits 1, as the JAX verb does."""
    audio_dir = tmp_path / "audio"
    save_wav(_chirp(7, 3.0, SR)[:, 0], audio_dir / "x.wav", SR)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(_serve_args(audio_dir, tmp_path / "r.txt", "--int16_io", "--ulaw_io"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        decode_for_classify(audio_dir / "x.wav", ModelConfig.load(BUNDLE_CONFIG),
                            int16_io=True, ulaw_io=True)
    assert main(_serve_args(audio_dir, tmp_path / "plain.txt")) == 0
    assert main(_serve_args(audio_dir, tmp_path / "bf16.txt", "--bf16")) == 0
    plain = (tmp_path / "plain.txt").read_text()
    assert plain and (tmp_path / "bf16.txt").read_text() == plain
    assert main(["nonsense"]) == 2
    for verb in ("train", "evaluate", "benchmark", "convert"):
        with pytest.raises(SystemExit) as exc:
            main([verb])
        assert exc.value.code == 2
    monkeypatch.chdir(tmp_path)  # no default deploy config here
    assert main(["deploy"]) == 1
    assert not (tmp_path / "r.txt").exists()


def test_default_device_raises_without_cuda(tmp_path):
    """Without --device the CLI runs on CUDA; without a card it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid here")
    audio_dir = tmp_path / "audio"
    save_wav(_chirp(8, 3.0, SR)[:, 0], audio_dir / "x.wav", SR)
    args = [a for a in _serve_args(audio_dir, tmp_path / "r.txt") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.load_model_runner(FLAGSHIP_TFLITE)


def test_load_model_runner_dispatch(tmp_path):
    runner = PR.load_model_runner(FLAGSHIP_TFLITE, device="cpu")
    assert isinstance(runner, PR.TFLiteSimRunner)
    assert PR._is_full_int8(runner.graph) and JR._is_full_int8(JTFLiteGraph(str(FLAGSHIP_TFLITE)))
    # A reference .keras archive loads through the transplant, with its
    # `<stem>_model_config.json` sidecar by default or `config_path`.
    from tests.torch_keras_archive import write_keras_archive
    from tests.torch_train_fixtures import pair

    _, variables, model, _, cfg = pair(seed=3)
    keras = write_keras_archive(tmp_path / "model.keras", variables, class_activation="none")
    with pytest.raises(FileNotFoundError, match="model_model_config.json"):
        PR.load_model_runner(keras, device="cpu")
    cfg.save(tmp_path / "model_model_config.json")
    x = np.random.default_rng(0).uniform(0, 1, (2, *cfg.input_shape())).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    for kw in ({}, {"config_path": tmp_path / "model_model_config.json"}):
        keras_runner = PR.load_model_runner(keras, device="cpu", **kw)
        assert isinstance(keras_runner, PR.TorchRunner)
        np.testing.assert_array_equal(keras_runner.predict(x), ref)
    # Run directories load (tests/test_torch_cli_train.py); one without the
    # port's best/state_dict.pt raises, a JAX (orbax) one saying so.
    with pytest.raises(FileNotFoundError, match="state_dict.pt"):
        PR.load_model_runner(tmp_path, device="cpu")
    (tmp_path / "best").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        PR.load_model_runner(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="Cannot infer"):
        PR.load_model_runner(tmp_path / "model.onnx", device="cpu")
    # A graph whose first conv has float weights is not full-int8, in both
    # packages.
    conv = next(op for op in runner.graph.ops if op.name == "CONV_2D")
    w = runner.graph.tensors[conv.inputs[1]]
    jgraph = JTFLiteGraph(str(FLAGSHIP_TFLITE))
    jw = jgraph.tensors[conv.inputs[1]]
    w.dtype = jw.dtype = "float32"
    assert not PR._is_full_int8(runner.graph) and not JR._is_full_int8(jgraph)


def test_sidecar_paths():
    assert resolve_config_path(FLAGSHIP_TFLITE) == str(BUNDLE_CONFIG)
    assert derive_sidecar_paths(str(FLAGSHIP_TFLITE)) == (
        str(BUNDLE_CONFIG), str(FLAGSHIP_TFLITE.parent / "labels.txt"))
    assert resolve_config_path(FLAGSHIP_TFLITE, "x.json") == "x.json"
    assert resolve_config_path("/nowhere/m_quantized.tflite") is None


def test_interpreter_runner_leg(monkeypatch):
    """A graph that is not full-int8 loads as TFLiteInterpreterRunner (the
    TFLite interpreter on the host): its predictions equal the JAX
    package's interpreter runner's bit for bit, and the classifier's
    interpreter leg is the interpreter on the frontend's features."""
    monkeypatch.setattr(PR, "_is_full_int8", lambda graph: False)
    runner = PR.load_model_runner(FLAGSHIP_TFLITE, device="cpu")
    assert isinstance(runner, PR.TFLiteInterpreterRunner)
    x = flagship_features(2, seed=3)
    np.testing.assert_array_equal(runner.predict(x),
                                  JR.TFLiteInterpreterRunner(FLAGSHIP_TFLITE).predict(x))
    cfg = ModelConfig.load(BUNDLE_CONFIG)
    waves = np.stack([_chirp(9, 3.0, SR)[:, 0], _chirp(10, 3.0, SR)[:, 0]])
    got = make_fused_classifier(runner, cfg, device="cpu")(waves)
    feats = frontend_input(torch.from_numpy(waves), cfg).numpy()
    assert got.shape == (2, 100)
    np.testing.assert_array_equal(got, runner.predict(feats))


def test_waits_for_stable_file_size(tmp_path):
    """Polling (not --once): a file is classified only once its size is the
    same at two polls (the copy-in-progress guard)."""
    from birdnet_stm32_tpu_torch.cli.serve import serve_loop

    audio_dir = tmp_path / "audio"
    save_wav(_chirp(11, 3.0, SR)[:, 0], audio_dir / "x.wav", SR)
    cfg = ModelConfig.load(BUNDLE_CONFIG)
    runner = PR.load_model_runner(FLAGSHIP_TFLITE, device="cpu")
    kw = dict(poll_interval=0.01, batch_size=4, device="cpu")
    assert serve_loop(runner, cfg, cfg.class_names, audio_dir, tmp_path / "r1.txt",
                      max_polls=1, **kw) == 0
    assert serve_loop(runner, cfg, cfg.class_names, audio_dir, tmp_path / "r2.txt",
                      max_polls=2, **kw) == 1
