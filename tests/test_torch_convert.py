"""PyTorch port, the convert chain: quant/validate.py, quant/calibrate.py,
models/convert.py::state_dict_to_flax, conversion/export_tflite.py,
conversion/pipeline.py and the `convert` verb, against the JAX package on
the same numpy-seeded inputs (tests/test_conversion.py's tiny geometry).

Tolerances, each where it is checked:
- cosine, Pearson, validate_runners: equal (float64 numpy on both sides);
- random_representative_inputs, stratified_sample_paths: equal;
- representative_inputs: the same kept count, features within 1e-5 (the
  composition's gate, tests/test_torch_float_configs.py);
- state_dict_to_flax: the exact inverse of flax_to_state_dict;
- build_tf_forward over the port's weights: bit-equal to JAX's (the same TF
  graph of the same float32 constants), and within 1e-5 of the port's
  DSCNN; learn_mel_scale: the port's tri_mel_matrix is the mixer, within
  1e-6 of JAX's at 16 mels (tests/test_torch_float_configs.py), so within
  1e-5 there too;
- convert_to_tflite and the verb's flatbuffer: byte-equal to JAX's for the
  same weights and the same representative array (int8 per-channel and per
  tensor, dynamic, float);
- convert_model's report: the same keys, equal sizes and head, validation
  stats within 1e-6 (float runners within 1e-5 of each other, the INT8
  executors bit-equal).

Eight TFLite conversions in all (the verb's four modes and JAX's four); the
gate and seed tests reuse the verb's flatbuffer instead of converting again.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.conversion import export_tflite as JE
from birdnet_stm32_tpu.conversion import pipeline as JPIPE
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu.quant import calibrate as JC
from birdnet_stm32_tpu.quant import validate as JV
from birdnet_stm32_tpu_torch.__main__ import main as verb
from birdnet_stm32_tpu_torch.audio.io import save_wav
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.conversion import export_tflite as PE
from birdnet_stm32_tpu_torch.conversion import pipeline as PPIPE
from birdnet_stm32_tpu_torch.data.dataset import load_file_paths_from_directory
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.quant import calibrate as PC
from birdnet_stm32_tpu_torch.quant import validate as PV
from birdnet_stm32_tpu_torch.training import checkpoint as PCKPT
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import N_CONFIGS
from tests.torch_fuzz_fixtures import load as load_fuzz
from tests.torch_train_fixtures import one_torch_thread, pair, write_run_dir  # noqa: F401
from tests.torch_train_fixtures import write_wav_folder

tf = pytest.importorskip("tensorflow")

warm_up()

# tests/test_conversion.py::tiny_cfg.
TINY_CFG = dict(sample_rate=4000, num_mels=16, spec_width=32, fft_length=128,
                chunk_duration=1.0, embeddings_size=32, num_classes=3,
                class_names=["a", "b", "c"], audio_frontend="hybrid", mag_scale="pwl",
                alpha=0.25)


def _cfgs(**kw):
    d = dict(TINY_CFG, **kw)
    return JaxModelConfig(**d), ModelConfig(**d)


def _equal_trees(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


# --- quant/validate.py ----------------------------------------------------

def _vector_cases():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=50), rng.normal(size=50)
    return {"random": (a, b), "scaled": (a, 3 * a), "opposite": (a, -a),
            "both_zero": (np.zeros(5), np.full(5, 1e-10)),
            "one_zero": (np.zeros(5), np.ones(5)), "a_constant": (np.full(6, 2.0), b[:6]),
            "both_constant": (np.full(4, 1.0), np.full(4, 3.0)),
            "float32_2d": (a.astype(np.float32).reshape(5, 10),
                           b.astype(np.float32).reshape(5, 10))}


@pytest.mark.parametrize("case", list(_vector_cases()))
def test_cosine_and_pearson_equal_jax(case):
    a, b = _vector_cases()[case]
    assert PV.cosine_similarity(a, b) == JV.cosine_similarity(a, b)
    assert PV.pearson_correlation(a, b) == JV.pearson_correlation(a, b)
    if case == "both_zero":
        assert PV.cosine_similarity(a, b) == 1.0
    if case == "one_zero":
        assert PV.cosine_similarity(a, b) == 0.0
    if case in ("a_constant", "both_constant"):
        assert PV.pearson_correlation(a, b) == 1.0


class _Stub:
    def __init__(self, table):
        self.table = table

    def predict(self, x):
        return self.table[np.asarray(x)[:, 0].astype(int)]


def test_validate_runners_equal_jax():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(70, 6)), rng.uniform(size=(70, 6))
    b[3] = a[3]
    x = np.arange(70, dtype=np.float32)[:, None]
    for bs in (32, 7):
        got = PV.validate_runners(_Stub(a), _Stub(b), x, batch_size=bs)
        assert got == JV.validate_runners(_Stub(a), _Stub(b), x, batch_size=bs)
        assert got["n_samples"] == 70 and abs(got["cosine_max"] - 1.0) < 1e-12
    empty = PV.validate_runners(_Stub(a), _Stub(b), x[:0])
    ref = JV.validate_runners(_Stub(a), _Stub(b), x[:0])
    assert empty.keys() == ref.keys() and empty["n_samples"] == ref["n_samples"] == 0
    assert all(np.isnan(v) for k, v in empty.items() if k != "n_samples")


# --- quant/calibrate.py -----------------------------------------------------

@pytest.mark.parametrize("frontend,mag", [("hybrid", "pwl"), ("raw", "none"),
                                          ("librosa", "none"), ("mfcc", "none")])
def test_random_representative_inputs_equal_jax(frontend, mag):
    jcfg, cfg = _cfgs(audio_frontend=frontend, mag_scale=mag)
    got = PC.random_representative_inputs(cfg, num_samples=5, seed=3)
    ref = JC.random_representative_inputs(jcfg, num_samples=5, seed=3)
    assert got.dtype == np.float32 and got.shape == (5, *cfg.input_shape())
    np.testing.assert_array_equal(got, ref)


def test_stratified_sample_paths_equal_jax():
    paths = [f"/d/{c}/{i}.wav" for c in "abcd" for i in range(7)]
    labels = [p.split("/")[2] for p in paths]
    for per_class, seed in ((3, 0), (10, 42), (1, 5)):
        got = PC.stratified_sample_paths(paths, labels, per_class, seed)
        assert got == JC.stratified_sample_paths(paths, labels, per_class, seed)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("calib")
    data = write_wav_folder(root / "data", files_per_class=3, seed=4)
    return data, sorted(str(p) for p in data.rglob("*.wav"))


@pytest.mark.parametrize("frontend,mag", [("hybrid", "pwl"), ("raw", "none"),
                                          ("librosa", "pwl"), ("log_mel", "none")])
def test_representative_inputs_match_jax(wavs, frontend, mag):
    _, files = wavs
    jcfg, cfg = _cfgs(audio_frontend=frontend, mag_scale=mag)
    for num, thr in ((8, 0.01), (100, 0.3)):
        ref = JC.representative_inputs(files, jcfg, num_samples=num, snr_threshold=thr, seed=7)
        got = PC.representative_inputs(files, cfg, num_samples=num, snr_threshold=thr, seed=7,
                                       device="cpu")
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_representative_inputs_silent_filters(tmp_path):
    silent = []
    for i in range(3):
        silent.append(str(tmp_path / f"s{i}.wav"))
        save_wav(np.zeros(6000, np.float32), silent[-1], 4000)
    for frontend, mag in (("raw", "none"), ("hybrid", "pwl")):
        jcfg, cfg = _cfgs(audio_frontend=frontend, mag_scale=mag)
        for mod, c, kw in ((PC, cfg, {"device": "cpu"}), (JC, jcfg, {})):
            with pytest.raises(ValueError, match="filtered as silent"):
                mod.representative_inputs(silent, c, num_samples=3, **kw)
            with pytest.raises(ValueError, match="No audio files"):
                mod.representative_inputs([], c, **kw)
    # With the filter off, silence is kept.
    _, cfg = _cfgs()
    assert len(PC.representative_inputs(silent, cfg, snr_threshold=0, device="cpu")) == 3


# --- models/convert.py::state_dict_to_flax -----------------------------------

def _ir_se_attention():
    """The inverted-residual + SE + attention-pooling config with seeded Flax
    variables (BN statistics moved off their init values)."""
    _, variables, _, jcfg, cfg = pair(2, use_inverted_residual=True, use_se=True,
                                      use_attention_pooling=True)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(1.5) + np.float32(0.1), variables["batch_stats"])
    return dict(variables, batch_stats=stats), jcfg, cfg


@pytest.mark.parametrize("i", [*range(N_CONFIGS), "ir_se_attention"])
def test_state_dict_to_flax_inverts_flax_to_state_dict(i):
    v = load_fuzz(i).variables if i != "ir_se_attention" else _ir_se_attention()[0]
    _equal_trees(state_dict_to_flax(flax_to_state_dict(v)), v)
    # And the other way: the port's state_dict survives the round trip and
    # loads strictly.
    sd = flax_to_state_dict(v)
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    if i != "ir_se_attention":
        f = load_fuzz(i)
        model = build_dscnn(ModelConfig.from_dict(f.cfg), device="cpu")
        model.load_state_dict(back, strict=True)


# --- conversion/export_tflite.py --------------------------------------------

def _export_cases():
    """(label, Flax variables, JAX cfg, port cfg, learn_mel_scale)."""
    out = []
    for i in (0, 1, 2, 3, 5):  # hybrid pwl / pcen, raw, librosa, log_mel + IR + SE + attn
        f = load_fuzz(i)
        out.append((f.label, f.variables, JaxModelConfig.from_dict(f.cfg),
                    ModelConfig.from_dict(f.cfg), False))
    v, jcfg, cfg = _ir_se_attention()
    out.append(("hybrid_ir_se_attention", v, jcfg, cfg, False))
    jcfg, cfg = _cfgs()
    jmodel = j_build_dscnn(jcfg, class_activation="none", learn_mel_scale=True)
    v = jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(9)))
    fe = v["params"]["audio_frontend"]
    fe["mel_seg_logits"] = np.asarray(fe["mel_seg_logits"]) + np.linspace(
        -0.5, 0.5, jcfg.num_mels + 1, dtype=np.float32)
    out.append(("learn_mel_scale", v, jcfg, cfg, True))
    return out


EXPORT_CASES = _export_cases()


@pytest.mark.parametrize("label,v,jcfg,cfg,learned", EXPORT_CASES,
                         ids=[c[0] for c in EXPORT_CASES])
def test_build_tf_forward_equals_jax(label, v, jcfg, cfg, learned):
    """Logits (class_activation 'none': the fuzz weights' softmax and
    sigmoid scores are near-uniform) of the TF graph built from the port's
    state_dict, bit-equal to the JAX package's graph from the Flax tree and
    within 1e-5 of the port's DSCNN."""
    x = np.random.default_rng(0).uniform(0, 1, (3, *cfg.input_shape())).astype(np.float32)
    if cfg.audio_frontend == "raw":
        x = x * 2 - 1
    pv = state_dict_to_flax(flax_to_state_dict(v))
    got = PE.build_tf_forward(pv, cfg, class_activation="none")(tf.constant(x)).numpy()
    ref = JE.build_tf_forward(v, jcfg, class_activation="none")(tf.constant(x)).numpy()
    if learned:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)
    model = build_dscnn(cfg, class_activation="none", learn_mel_scale=learned, device="cpu")
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(got, model(torch.from_numpy(x)).numpy(), rtol=0, atol=1e-5)


def test_fuse_bn_and_quantize_check_equal_jax():
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    p = {"scale": rng.normal(size=8).astype(np.float32),
         "bias": rng.normal(size=8).astype(np.float32)}
    s = {"mean": rng.normal(size=8).astype(np.float32),
         "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    for kernel, axis in ((k, -1), (np.ascontiguousarray(k.transpose(3, 0, 1, 2)), 0)):
        got = PE.fuse_bn(kernel, p, s, channel_axis=axis)
        ref = JE.fuse_bn(kernel, p, s, channel_axis=axis)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    _, _, model, _, cfg = pair(0)
    with pytest.raises(ValueError, match="quantize='ptq'"):
        PE.convert_to_tflite({}, cfg, quantize="ptq")
    with pytest.raises(ValueError, match="representative"):
        PE.convert_to_tflite(state_dict_to_flax(model.state_dict()), cfg, None)


# --- the verb, the pipeline and the flatbuffers -------------------------------

@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The verb's four modes on a port run directory (sigmoid head) with
    --device cpu, and JAX's conversions of the same weights from the same
    representative array: convert_model (int8) and convert_to_tflite
    (per-tensor int8, dynamic, float)."""
    root = tmp_path_factory.mktemp("convert")
    data = write_wav_folder(root / "data", files_per_class=3, seed=5)
    run = root / "run"
    jmodel, variables, jcfg, cfg = write_run_dir(run, seed=1)
    common = ["convert", "--model_path", str(run), "--device", "cpu",
              "--min_cosine_sim", "0.5"]
    out = {"root": root, "data": data, "run": run, "cfg": cfg}
    # The verb's calibration array, recomputed (the CPU path is
    # deterministic): JAX converts from the same array.
    paths, labels, _ = load_file_paths_from_directory(data, classes=cfg.class_names)
    calib = PC.representative_inputs(PC.stratified_sample_paths(paths, labels, 10, 42), cfg,
                                     seed=42, device="cpu")
    out.update(calib=calib, jax=(jmodel, variables, jcfg))
    assert verb([*common, "--data_path", str(data), "--quantize", "ptq",
                 "--output_path", str(root / "int8.tflite"),
                 "--report_json", str(root / "int8.json")]) == 0
    assert verb([*common, "--data_path", str(data), "--per_tensor", "--no_npz",
                 "--output_path", str(root / "per_tensor.tflite")]) == 0
    assert verb([*common, "--quantize", "dynamic",
                 "--output_path", str(root / "dynamic.tflite")]) == 0
    assert verb([*common, "--quantization", "float",
                 "--output_path", str(root / "float.tflite")]) == 0
    jroot = root / "jax"
    out["jax_report"] = JPIPE.convert_model(
        jmodel, variables, jcfg, jroot / "int8.tflite", calibration_inputs=calib,
        min_cosine_sim=0.5, seed=42)
    for name, kw in (("per_tensor", dict(representative=calib, per_channel=False)),
                     ("dynamic", dict(quantize="dynamic")), ("float", dict(quantize="float"))):
        (jroot / f"{name}.tflite").write_bytes(
            JE.convert_to_tflite(variables, jcfg, class_activation="sigmoid", **kw))
    return out


@pytest.mark.parametrize("mode", ["int8", "per_tensor", "dynamic", "float"])
def test_verb_flatbuffer_equals_jax_export(converted, mode):
    root = converted["root"]
    got = (root / f"{mode}.tflite").read_bytes()
    ref = (root / "jax" / f"{mode}.tflite").read_bytes()
    assert len(got) == len(ref) and got == ref


def test_report_equals_jax(converted):
    root = converted["root"]
    got = json.loads((root / "int8_report.json").read_text())
    ref = converted["jax_report"]
    assert json.loads((root / "int8.json").read_text()).keys() == ref.keys()
    assert set(got) == set(ref) - {"report_path"}
    for k in ("quantize", "class_activation", "tflite_bytes", "float32_bytes",
              "compression_ratio"):
        assert got[k] == ref[k], k
    assert got["class_activation"] == "sigmoid"  # the run's multilabel head
    g, r = got["validation"], ref["validation"]
    assert g["n_samples"] == r["n_samples"] == min(64, len(converted["calib"]))
    for k in g:
        assert abs(g[k] - r[k]) <= 1e-6, (k, g[k], r[k])
    npz, jnpz = np.load(root / "int8_validation_data.npz"), np.load(ref["validation_npz"])
    assert set(npz.files) == set(jnpz.files) == {"inputs", "float_outputs", "quant_outputs"}
    for k in npz.files:
        assert npz[k].shape == jnpz[k].shape and npz[k].dtype == jnpz[k].dtype, k
    assert not (root / "per_tensor_validation_data.npz").exists()  # --no_npz
    for mode in ("dynamic", "float"):
        rep = json.loads((root / f"{mode}_report.json").read_text())
        assert "validation" not in rep and rep["quantize"] == mode


def _cached_export(converted, monkeypatch):
    """Make both pipelines' exports return the verb's int8 flatbuffer."""
    blob = (converted["root"] / "int8.tflite").read_bytes()
    for mod in (PPIPE, JPIPE):
        monkeypatch.setattr(mod, "convert_to_tflite", lambda *a, **k: blob)


def test_validation_seeds_keep_the_worst(converted, monkeypatch, tmp_path):
    """--num_validation_seeds 2: the worst of two shuffled subsets, equal to
    the JAX pipeline's choice on the same flatbuffer."""
    _cached_export(converted, monkeypatch)
    model, sd, cfg = PCKPT.load_checkpoint(converted["run"], device="cpu")
    jmodel, variables, jcfg = converted["jax"]
    x = converted["calib"]
    kw = dict(calibration_inputs=x, num_validation_seeds=2, num_validation_samples=6,
              min_cosine_sim=0.0, seed=3, save_npz=False)
    got = PPIPE.convert_model(model, sd, cfg, tmp_path / "p.tflite", device="cpu", **kw)
    ref = JPIPE.convert_model(jmodel, variables, jcfg, tmp_path / "j.tflite", **kw)
    rng = np.random.default_rng(3)
    runners = (PPIPE.TorchRunner(model, cfg, device="cpu"),
               PPIPE.TFLiteSimRunner(tmp_path / "p.tflite", device="cpu"))
    means = [PV.validate_runners(*runners, x[rng.permutation(len(x))[:6]])["cosine_mean"]
             for _ in range(2)]
    assert means[0] != means[1]
    assert got["validation"]["cosine_mean"] == min(means)
    for k, v in got["validation"].items():
        assert abs(v - ref["validation"][k]) <= 1e-6, k


@pytest.mark.parametrize("case", ["impossible", "nan"])
def test_gate_fails(converted, monkeypatch, tmp_path, case):
    """An impossible threshold and an empty validation set (NaN) raise, in
    the port as in the JAX package."""
    _cached_export(converted, monkeypatch)
    model, sd, cfg = PCKPT.load_checkpoint(converted["run"], device="cpu")
    jmodel, variables, jcfg = converted["jax"]
    x = converted["calib"]
    kw = (dict(min_cosine_sim=1.0 + 1e-9) if case == "impossible"
          else dict(validation_inputs=x[:0], min_cosine_sim=0.0))
    with pytest.raises(RuntimeError, match="gate failed"):
        PPIPE.convert_model(model, sd, cfg, tmp_path / "p.tflite", calibration_inputs=x,
                            device="cpu", **kw)
    with pytest.raises(RuntimeError, match="gate failed"):
        JPIPE.convert_model(jmodel, variables, jcfg, tmp_path / "j.tflite",
                            calibration_inputs=x, **kw)


def test_verb_exits(converted, tmp_path, monkeypatch, capsys):
    run, data = converted["run"], converted["data"]
    # An empty calibration folder: SystemExit, no fallback to random data.
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no calibration audio"):
        verb(["convert", "--model_path", str(run), "--data_path", str(tmp_path / "empty"),
              "--device", "cpu"])
    # --stablehlo writes the torch.export serving module beside the
    # .tflite, and it scores the run's model; a reference .keras archive
    # converts through the transplant with --model_config as its sidecar.
    from birdnet_stm32_tpu_torch.conversion.export_program import load_serving_fn
    from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
    from tests.torch_keras_archive import write_keras_archive

    _cached_export(converted, monkeypatch)
    capsys.readouterr()
    assert verb(["convert", "--model_path", str(run), "--stablehlo", "--device", "cpu",
                 "--min_cosine_sim", "0.0", "--output_path", str(tmp_path / "s.tflite")]) == 0
    assert "torch.export serving module" in capsys.readouterr().out
    model, _, cfg = PCKPT.load_checkpoint(run, device="cpu")
    wave = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, (64, cfg.chunk_samples)).astype(np.float32))
    with torch.no_grad():
        ref_scores = model(inputs_for_config(wave, cfg))
    got = load_serving_fn((tmp_path / "s.pt2").read_bytes())(wave)
    torch.testing.assert_close(got, ref_scores, atol=1e-5, rtol=0)
    ref = tmp_path / "reference.keras"
    write_keras_archive(ref, state_dict_to_flax(model.state_dict()), class_activation="sigmoid")
    cfg.save(tmp_path / "sidecar.json")
    assert verb(["convert", "--checkpoint_path", str(ref), "--model_config",
                 str(tmp_path / "sidecar.json"), "--device", "cpu", "--no_npz",
                 "--min_cosine_sim", "0.0"]) == 0
    report_line = capsys.readouterr().out
    assert (tmp_path / "reference_quantized.tflite").exists(), report_line
    # Without TensorFlow the verb exits 2 before it loads or calibrates.
    monkeypatch.setitem(sys.modules, "tensorflow", None)

    def forbidden(*a, **k):
        raise AssertionError("loaded or calibrated without TensorFlow")

    monkeypatch.setattr(PCKPT, "load_checkpoint", forbidden)
    monkeypatch.setattr(PPIPE, "representative_inputs", forbidden)
    monkeypatch.setattr(PPIPE, "convert_model", forbidden)
    assert verb(["convert", "--model_path", str(run), "--data_path", str(data),
                 "--device", "cpu"]) == 2
    assert "TensorFlow" in capsys.readouterr().err


def test_verb_onnx_warning(converted, tmp_path, monkeypatch, capsys):
    """--onnx without tf2onnx: a warning, and the conversion stands (the
    export returns the int8 flatbuffer here, to convert no more)."""
    monkeypatch.setitem(sys.modules, "tf2onnx", None)
    _cached_export(converted, monkeypatch)
    assert verb(["convert", "--model_path", str(converted["run"]), "--device", "cpu",
                 "--quantize", "float", "--onnx",
                 "--output_path", str(tmp_path / "m.tflite")]) == 0
    assert "tf2onnx is not installed" in capsys.readouterr().out
    assert (tmp_path / "m.tflite").read_bytes() == (converted["root"] / "int8.tflite").read_bytes()


def test_verb_arguments_match_jax():
    """Every flag and alias of the JAX verb parses to the same values."""
    from birdnet_stm32_tpu.cli.convert import get_args as jargs
    from birdnet_stm32_tpu_torch.cli.convert import get_args as pargs

    for argv in (["--model_path", "m"],
                 ["--checkpoint_path", "m", "--data_path_train", "d", "--quantization", "ptq",
                  "--num_samples", "7", "--batch_validate", "3", "--export_onnx",
                  "--per_tensor", "--no_npz", "--validate_samples", "9",
                  "--calibration_per_class", "2", "--min_cosine_sim", "0.9", "--seed", "1",
                  "--report_json", "r.json", "--output_path", "o.tflite",
                  "--model_config", "c.json", "--stablehlo"]):
        got, ref = vars(pargs(argv)), vars(jargs(argv))
        assert got.pop("device") == "cuda"
        assert got == ref
