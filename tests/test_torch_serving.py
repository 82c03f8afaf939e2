"""PyTorch port, the slice end to end, and the rules of the port.

The port's make_fused_classifier on the CPU against the JAX
make_fused_classifier(FlaxRunner, pallas_mode='interpret') on the same
waveforms, with the same (converted) weights: atol 5e-5 on softmax scores,
the tolerance tests/test_pallas.py uses between the JAX kernel and XLA
paths (float32 on both sides, summation order differs through the whole
frontend + DS-CNN chain).
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu.models.runners import FlaxRunner
from birdnet_stm32_tpu.models.serving import make_fused_classifier as j_make_fused_classifier
from birdnet_stm32_tpu.models.serving import top_predictions as j_top_predictions
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
from birdnet_stm32_tpu_torch.models.runners import TorchRunner
from birdnet_stm32_tpu_torch.models.serving import (
    classify_in_batches,
    make_fused_classifier,
    top_predictions,
)
from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
from tests.test_torch_cpu_warmup import warm_up

warm_up()

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(sample_rate=8000, num_mels=32, spec_width=32, fft_length=256,
             chunk_duration=1.0, embeddings_size=32, num_classes=4,
             class_names=list("abcd"), alpha=0.25, audio_frontend="hybrid",
             mag_scale="pwl", use_se=False, use_inverted_residual=False)


@functools.lru_cache(maxsize=None)
def _pair(frontend: str, mag_scale: str):
    """(JAX classifier, port classifier on the CPU, cfg) with shared weights."""
    kw = dict(SMALL, audio_frontend=frontend, mag_scale=mag_scale)
    jcfg = JaxModelConfig(**kw)
    jmodel = j_build_dscnn(jcfg)
    v = jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(0)))
    j_classify = j_make_fused_classifier(FlaxRunner(jmodel, v, jcfg), jcfg,
                                         pallas_mode="interpret")
    cfg = ModelConfig(**kw)
    model = build_dscnn(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    t_classify = make_fused_classifier(TorchRunner(model, cfg, device="cpu"), cfg,
                                       device="cpu")
    return j_classify, t_classify, cfg


@pytest.fixture(scope="module")
def pair():
    return _pair("hybrid", "pwl")


def _waves(seed, n, cfg):
    return np.random.default_rng(seed).normal(0, 0.5, (n, cfg.chunk_samples)).astype(np.float32)


@pytest.mark.parametrize("frontend,mag_scale", [("hybrid", "pwl"), ("librosa", "pwl"),
                                                ("librosa", "pcen"), ("log_mel", "pwl"),
                                                ("mfcc", "pwl")])
def test_fused_classifier_matches_jax(frontend, mag_scale):
    """The slice end to end for each served frontend: the JAX classifier
    runs its Pallas kernel in interpret mode (pcen included), the port its
    plain version; converted weights, the precomputed-frontend DS-CNN at
    [B, 32, 32, 1] (mfcc [B, 20, 32, 1]) for all but hybrid."""
    j_classify, t_classify, cfg = _pair(frontend, mag_scale)
    wave = _waves(0, 4, cfg)
    before = frontend_kernel.launches.total()
    got = t_classify(wave)
    assert frontend_kernel.launches.total() == before  # CPU: the plain version, no launch
    ref = np.asarray(j_classify(wave))
    assert got.shape == ref.shape == (4, cfg.num_classes)
    np.testing.assert_allclose(got, ref, atol=5e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_classify_in_batches_pads_ragged_tail(pair):
    _, t_classify, cfg = pair
    chunks = _waves(1, 7, cfg)
    scores, seconds = classify_in_batches(t_classify, chunks, batch_size=3)
    assert scores.shape == (7, cfg.num_classes) and seconds > 0
    # The padded tail batch gives the tail chunk the scores it gets alone.
    np.testing.assert_allclose(scores[6:], t_classify(chunks[6:]), atol=1e-6)
    np.testing.assert_allclose(scores[:3], t_classify(chunks[:3]), atol=1e-6)


def test_runner_predict_scores_features(pair):
    """TorchRunner.predict takes model inputs (features), as FlaxRunner does."""
    _, t_classify, cfg = pair
    wave = _waves(2, 2, cfg)
    model = build_dscnn(cfg, device="cpu")
    runner = TorchRunner(model, cfg, device="cpu")
    feats = frontend_input(torch.from_numpy(wave), cfg).numpy()
    classify = make_fused_classifier(runner, cfg, device="cpu")
    np.testing.assert_allclose(runner.predict(feats), classify(wave), atol=1e-6)


@pytest.mark.parametrize("thr", [0.3, [0.1, 0.5, 0.2, 0.9]])
def test_top_predictions_matches_jax(thr):
    pooled = np.array([0.2, 0.35, 0.05, 0.4], np.float32)
    for k in (1, 2, 4):
        assert top_predictions(pooled, k, thr) == j_top_predictions(pooled, k, thr)


def test_entry_points_default_to_cuda():
    """Without device=, entry points run on CUDA; on a machine without it
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid here")
    cfg = ModelConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_dscnn(cfg)
    model = build_dscnn(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchRunner(model, cfg)
    runner = TorchRunner(model, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fused_classifier(runner, cfg)


def test_runner_device_must_match_classifier():
    cfg = ModelConfig(**SMALL)
    runner = TorchRunner(build_dscnn(cfg, device="cpu"), cfg, device="cpu")
    with pytest.raises(ValueError, match="runner is on"):
        make_fused_classifier(runner, cfg, device="meta")


def test_seeded_init_is_reproducible():
    cfg = ModelConfig(**SMALL)
    a = init_model(build_dscnn(cfg, device="cpu"), seed=5).state_dict()
    b = init_model(build_dscnn(cfg, device="cpu"), seed=5).state_dict()
    c = init_model(build_dscnn(cfg, device="cpu"), seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem_conv.weight"], c["stem_conv.weight"])


def _port_sources():
    # chip_smoke.py and the test helpers it imports (the INT8 fixture, the
    # tiny op graphs, the fuzz fixture loader) run on the card machine,
    # which has no JAX.
    return sorted((REPO / "birdnet_stm32_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "int8_fixture.py",
        REPO / "tests" / "int8_op_graphs.py", REPO / "tests" / "torch_fuzz_fixtures.py",
        REPO / "tests" / "make_torch_convert_fixtures.py",
        REPO / "tests" / "make_torch_transplant_fixtures.py",
        REPO / "tests" / "torch_keras_archive.py", REPO / "tests" / "torch_ddp_worker.py"]


# TFLiteInterpreterRunner (graphs that are not full-int8) is the TFLite
# interpreter itself, so it imports TensorFlow, inside its constructor only:
# the module imports without it, and the card machine has none. Plots import
# matplotlib inside evaluation/reporting.py's functions only, which skip
# without it (the card machine has none either). The TFLite export builds
# its graph in TensorFlow inside its functions, and the convert verb imports
# it inside main() to exit 2 where it cannot (and for --onnx). The .keras
# transplant and the test archive writer read and write HDF5 with h5py
# inside their functions (the card machine has no h5py).
LAZY_IMPORTS = {"birdnet_stm32_tpu_torch/models/runners.py": {"tensorflow"},
                "birdnet_stm32_tpu_torch/evaluation/reporting.py": {"matplotlib"},
                "birdnet_stm32_tpu_torch/conversion/export_tflite.py": {"tensorflow"},
                "birdnet_stm32_tpu_torch/cli/convert.py": {"tensorflow"},
                "birdnet_stm32_tpu_torch/models/transplant.py": {"h5py"},
                "tests/torch_keras_archive.py": {"h5py"}}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No module of the port, not chip_smoke.py and not the test helpers it
    imports jax, flax, tensorflow, flatbuffers, sklearn, matplotlib or the
    JAX package (matched on the exact top-level name); the exceptions are
    LAZY_IMPORTS, and only inside a function body."""
    banned = {"jax", "flax", "tensorflow", "flatbuffers", "sklearn", "matplotlib", "h5py",
              "birdnet_stm32_tpu"}
    tree = ast.parse(path.read_text())
    in_function = {id(n) for f in ast.walk(tree)
                   if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for n in ast.walk(f)}
    lazy = LAZY_IMPORTS.get(str(path.relative_to(REPO)), set())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in lazy and id(node) in in_function:
                continue
            assert top not in banned, f"{path}: imports {name}"


def test_port_sources_cover_the_serve_slice():
    """The scan above reaches the modules of the serve path."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("__main__.py", "cli/serve.py", "cli/deploy.py", "audio/io.py",
                   "ops/resample.py", "data/worker.py", "data/dataset.py", "data/species.py",
                   "evaluation/metrics.py", "models/serving.py", "models/runners.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned


def test_port_sources_cover_the_train_slice():
    """The scan reaches every module of the `train` path."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("cli/train.py", "utils/prng.py", "audio/activity.py", "data/augment.py",
                   "data/pipeline.py", "parallel/steps.py", "training/losses.py",
                   "training/optimizer.py", "training/checkpoint.py", "training/trainer.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned


def test_port_sources_cover_the_train_options_slice():
    """The scan reaches every module of the train options (mixed precision,
    QAT, linear probe, LR finder, tuner) and distillation."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("quant/fake_quant.py", "quant/qat.py", "training/linear_probe.py",
                   "training/lr_finder.py", "training/tuner.py", "training/distillation.py",
                   "utils/logging.py", "models/blocks.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned


def test_port_sources_cover_the_evaluate_slice():
    """The scan reaches every module of the evaluate, benchmark, board-test
    and profile verbs."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("cli/evaluate.py", "cli/benchmark.py", "cli/board_test.py", "cli/profile.py",
                   "deploy/config.py", "evaluation/pooling.py", "evaluation/ranking.py",
                   "evaluation/reporting.py", "models/registry.py", "models/profiler.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned


def test_port_sources_cover_the_last_slice():
    """The scan reaches the transplant, the export program, the native audio
    library, the data-parallel modules and their fixtures and workers."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("models/transplant.py", "conversion/export_program.py", "audio/native.py",
                   "parallel/mesh.py", "parallel/distributed.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned
    for helper in ("make_torch_transplant_fixtures.py", "torch_keras_archive.py",
                   "torch_ddp_worker.py"):
        assert f"tests/{helper}" in scanned


def test_port_sources_cover_the_mesh_slice():
    """The scan reaches the serving mesh's modules and the multi-card dry
    run, which the card machine runs."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("parallel/mesh.py", "parallel/steps.py", "models/runners.py",
                   "models/serving.py", "scripts/multichip.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned


def test_port_sources_cover_the_convert_and_deploy_slice():
    """The scan reaches every module of the convert and deploy verbs and the
    API tail that rode with them."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for module in ("quant/validate.py", "quant/calibrate.py", "models/convert.py",
                   "conversion/__init__.py", "conversion/export_tflite.py",
                   "conversion/pipeline.py", "cli/convert.py", "deploy/headers.py",
                   "cli/deploy.py", "models/__init__.py", "audio/spectrogram.py"):
        assert f"birdnet_stm32_tpu_torch/{module}" in scanned


def test_port_sources_cover_every_served_model():
    """The scan reaches the modules that serve every model the dispatch
    accepts (bf16 leg, pcen / raw / learned-mel frontends, the whole
    executor) and the fixture helpers the card reads."""
    scanned = {str(p.relative_to(REPO)) for p in _port_sources()}
    for path in ("birdnet_stm32_tpu_torch/models/frontend_layer.py",
                 "birdnet_stm32_tpu_torch/models/dscnn.py",
                 "birdnet_stm32_tpu_torch/models/convert.py",
                 "birdnet_stm32_tpu_torch/ops/stft.py",
                 "birdnet_stm32_tpu_torch/ops/spectrogram.py",
                 "birdnet_stm32_tpu_torch/device.py",
                 "birdnet_stm32_tpu_torch/quant/tflite_import.py",
                 "tests/int8_op_graphs.py", "tests/torch_fuzz_fixtures.py"):
        assert path in scanned
