"""EfficientNet-B1 in the port (models/efficientnet.py) against its plain
float32 reference (tests/torch_ref_efficientnet.py) on the CPU, at B1's
full widths and a small input, on the benchmark's seeded weights
(gpubench/weights.py); its stage table, parameter and MAC counts against
the paper; its spans; and building it by the name a run directory's
model_config.json gives."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models import DSCNN, build_model, list_models
from birdnet_stm32_tpu_torch.models.blocks import add_se_block
from birdnet_stm32_tpu_torch.models.efficientnet import (
    EfficientNet,
    build_efficientnet,
    stage_table,
)
from birdnet_stm32_tpu_torch.models.runners import TorchRunner, load_model_runner
from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.utils import tracing
from gpubench.correctness import _fp8
from gpubench.reference import efficientnet as bench_reference
from gpubench.weights import seeded_state
from gpubench.yardstick.macs_efficientnet import backbone_macs
from tests import torch_ref_efficientnet as ref
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401  (autouse)

warm_up()

# A small input at B1's widths: 32 mels x 64 frames of precomputed
# features (the librosa frontend slices them), so the model's input is the
# spectrogram the reference takes.
SMALL = {"model": "efficientnet", "architecture": "efficientnet_b1", "sample_rate": 8000,
         "chunk_duration": 1.0, "num_mels": 32, "spec_width": 64, "fft_length": 128,
         "audio_frontend": "librosa", "mag_scale": "pwl", "embeddings_size": 1280,
         "num_classes": 100}
ROWS = 3
# float32: the port and the reference run the same float32 convolution
# routines on the same padded tensors and differ in the order of BN's
# operations only; 1e-6 of a logit is ten times the largest gap seen
# (1e-7, logits ~0.3).
F32_ATOL = 1e-6
# bfloat16: the served precision, every activation rounded to 8 bits of
# mantissa, reads 1.4e-3 to 2.0e-3 of a logit over six seeds; fp8 (e4m3)
# operands in the reference read 1.0e-2 to 1.5e-2. The bound sits 2.5x
# above the one and 2x below the other.
BF16_ATOL = 5e-3


def seeded(cfg_dict: dict, seed: int, class_activation: str = "none"):
    """(model, float32 state) on the CPU with the benchmark's seeded weights."""
    model = build_efficientnet(ModelConfig.from_dict(cfg_dict), class_activation, device="cpu")
    state = seeded_state(model.state_dict(), cfg_dict, seed, "cpu")
    model.load_state_dict(state, strict=False)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def features(seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(ROWS, SMALL["num_mels"], SMALL["spec_width"], 1, generator=g)


def test_stage_table_is_b1s():
    blocks = stage_table()
    assert len(blocks) == 23
    stages = [[b for b in blocks if b.name[5] == str(s)] for s in range(1, 8)]
    assert [len(s) for s in stages] == [2, 3, 3, 4, 4, 5, 2]
    assert [s[0].cout for s in stages] == [16, 24, 40, 80, 112, 192, 320]
    assert [s[0].kernel for s in stages] == [3, 3, 5, 3, 5, 5, 3]
    assert [s[0].stride for s in stages] == [1, 2, 2, 2, 1, 2, 1]
    assert [s[0].expansion for s in stages] == [1, 6, 6, 6, 6, 6, 6]
    assert all(b.stride == 1 and b.cin == b.cout for s in stages for b in s[1:])
    assert [b.se_width for b in blocks[:4]] == [8, 4, 4, 6]  # a quarter of the input width
    assert [b.se_width for b in blocks[-2:]] == [48, 80]
    table = [(b.name, b.cin, b.cout, b.kernel, b.stride, b.expansion) for b in blocks]
    assert table == ref.BLOCKS
    assert [(*t, b.se_width) for t, b in zip(table, blocks)] == bench_reference.blocks()


def test_layers_carry_keras_names():
    model = EfficientNet(ModelConfig.from_dict(SMALL))
    names = {k.rsplit(".", 1)[0] for k in model.state_dict()}
    assert {"stem_conv", "stem_bn", "block1a_dwconv", "block1a_bn", "block1a_se_reduce",
            "block1a_se_expand", "block1a_project_conv", "block1a_project_bn",
            "block2a_expand_conv", "block2a_expand_bn", "block7b_project_bn", "top_conv",
            "top_bn", "predictions"} <= names
    assert "block1a_expand_conv" not in names
    assert model.block5a_dwconv.kernel_size == (5, 5) and model.block2a_dwconv.stride == (2, 2)
    assert model.block2a_se_reduce.bias is not None


def test_parameter_count_within_one_percent_of_the_paper():
    # The paper's 7.8 M for B1: backbone and a 1,000-class head, without
    # the port's audio frontend (a 1-channel stem holds 576 fewer weights
    # than an RGB one).
    model = EfficientNet(ModelConfig.from_dict({**SMALL, "num_classes": 1000}))
    n = sum(p.numel() for k, p in model.named_parameters() if not k.startswith("audio_frontend"))
    assert n == 7_793_608
    assert n == pytest.approx(7.8e6, rel=0.01)


def test_macs_at_240_within_three_percent_of_the_paper():
    assert backbone_macs(240, 240, 3, 1000) == pytest.approx(0.70e9, rel=0.03)


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_matches_the_reference(seed):
    model, state = seeded(SMALL, seed)
    x = features(100 + seed)
    with torch.no_grad():
        got = model(x)
    want = ref.logits(state, x.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want, rtol=0, atol=F32_ATOL)
    # The rows' logits differ by far more than the bound, so it sees the input.
    assert (want - want[0]).abs().max() > 20 * F32_ATOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfloat16_matches_the_reference_and_fp8_does_not(seed):
    model, state = seeded(SMALL, seed)
    x = features(100 + seed)
    got = TorchRunner(model, ModelConfig.from_dict(SMALL), device="cpu",
                      dtype=torch.bfloat16).forward(x)
    want = ref.logits(state, x.permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert (got - want).abs().max() < BF16_ATOL
    control = bench_reference.backbone(state, x.permute(0, 3, 1, 2), _fp8)
    assert (control - want).abs().max() > BF16_ATOL


def test_waveforms_through_the_fused_classifier():
    # The hybrid frontend (the kernel's plain version on the CPU) at 8 kHz,
    # 1 s, 64 frames, then the model, through the path `serve` takes;
    # against the port's composition features fed to the plain reference
    # (the mixer and pwl written out, then the backbone).
    cfg_dict = {**SMALL, "audio_frontend": "hybrid"}
    cfg = ModelConfig.from_dict(cfg_dict)
    model, state = seeded(cfg_dict, 3, class_activation="sigmoid")
    wave = np.random.default_rng(3).normal(0, 0.2, (ROWS, cfg.chunk_samples)).astype(np.float32)
    classify = make_fused_classifier(TorchRunner(model, cfg, device="cpu"), cfg,
                                     as_numpy=True, device="cpu")
    got = classify(wave)
    feats = inputs_for_config(torch.from_numpy(wave), cfg)
    spec = bench_reference.spectrogram(state, feats, cfg_dict)
    want = torch.sigmoid(ref.logits(state, spec)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_spans_mark_each_blocks_convolutions_and_se():
    model, _ = seeded(SMALL, 4)
    x = features(4)
    assert tracing.span(tracing.MBCONV_DW) is tracing._NO_SPAN  # untraced: the shared no-op
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.no_grad(), torch.profiler.profile(activities=cpu) as prof:
        model(x)
    counts = {}
    for e in prof.events():
        if e.name.startswith("mbconv."):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"mbconv.expand": 21, "mbconv.dw": 23, "mbconv.se": 23,
                      "mbconv.project": 23}
    assert len(model.blocks) == 23


def _run_dir(tmp_path: Path, model: torch.nn.Module, cfg: ModelConfig) -> Path:
    (tmp_path / "best").mkdir()
    torch.save(model.state_dict(), tmp_path / "best" / "state_dict.pt")
    cfg.save(tmp_path / "model_config.json")
    return tmp_path


def test_a_run_directory_builds_its_architecture(tmp_path):
    cfg = ModelConfig.from_dict(SMALL)
    model, _ = seeded(SMALL, 5, class_activation="softmax")
    run = _run_dir(tmp_path, model, cfg)
    assert json.loads((run / "model_config.json").read_text())["architecture"] == "efficientnet_b1"
    runner = load_model_runner(run, device="cpu")
    assert isinstance(runner.model, EfficientNet)
    x = features(5)
    with torch.no_grad():
        want = model(x)
    torch.testing.assert_close(runner.forward(x), want, rtol=0, atol=0)


def test_a_run_directory_without_the_key_builds_the_dscnn(tmp_path):
    cfg = ModelConfig(sample_rate=8000, chunk_duration=1.0, num_mels=16, spec_width=32,
                      fft_length=128, alpha=0.25, embeddings_size=32, num_classes=3)
    run = _run_dir(tmp_path, build_model("dscnn", cfg, device="cpu"), cfg)
    # A sidecar written before `architecture` existed (or by the JAX package).
    sidecar = json.loads((run / "model_config.json").read_text())
    assert sidecar.pop("architecture") == "dscnn"
    (run / "model_config.json").write_text(json.dumps(sidecar))
    assert isinstance(load_model_runner(run, device="cpu").model, DSCNN)


def test_an_unknown_architecture_names_the_registered_ones(tmp_path):
    cfg = ModelConfig.from_dict({**SMALL, "architecture": "efficientnet_b7"})
    with pytest.raises(KeyError, match=r"'dscnn', 'efficientnet_b1'"):
        build_model(cfg.architecture, cfg, device="cpu")
    assert list_models() == ["dscnn", "efficientnet_b1"]
    with pytest.raises(ValueError, match="is not 'efficientnet_b1'"):
        build_efficientnet(cfg, device="cpu")
    with pytest.raises(ValueError, match="embeddings_size 256"):
        build_efficientnet(ModelConfig.from_dict({**SMALL, "embeddings_size": 256}), device="cpu")


def test_the_dscnn_se_keeps_its_layers():
    # The SE's new keywords default to the DS-CNN's bias-free dense layers
    # through channels // reduction.
    parent = torch.nn.Module()
    add_se_block(parent, "s", 64, 8)
    assert parent.s_reduce.weight.shape == (8, 64) and parent.s_reduce.bias is None
    assert parent.s_expand.weight.shape == (64, 8) and parent.s_expand.bias is None
