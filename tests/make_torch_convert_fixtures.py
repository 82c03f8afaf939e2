"""Write the convert fixture of the PyTorch port, and read it back.

The port's `convert` needs TensorFlow for the TFLite export; the card
machine has none. So the export is made once where TensorFlow is, and the
card (chip_smoke.py) and the tests hold the rest of the chain against it:
calibration features, the float and INT8 runners, the validation stats and
`deploy`. Run from the repository root (TensorFlow, no JAX, ~30 s):

    python -m tests.make_torch_convert_fixtures

It writes tests/goldens/torch_convert/:

- state_dict.npz: the flagship geometry
  (artifacts/flagship/bundle/model_config.json, full width, 224,388
  parameters) with the port's seeded weights, init_model(seed=0);
- model_quantized.tflite and model_quantized_report.json: the port's
  `convert` of a run directory holding those weights (softmax head),
  calibrated on write_train_folder's seeded WAV folder (below) with
  the verb's defaults (seed 42, 10 files per class, 100 samples) on the
  CPU, no validation NPZ;
- model_config.json and labels.txt: the sidecars `deploy` derives for it.

The softmax head is the one the cosine gate bites on: against this model's
float scores on the validation inputs, a constant vector reads a mean
cosine of 0.834 and the class-shuffled scores 0.683, both below
the 0.95 gate (the sigmoid head's constant vector reads about 0.95, which
would pass). The script asserts that before it writes anything.

The helpers below import neither JAX nor TensorFlow: chip_smoke.py uses
them on the card. Not collected by pytest (its name does not start with
test_).
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "goldens" / "torch_convert"
FLAGSHIP_CONFIG = ROOT / "artifacts" / "flagship" / "bundle" / "model_config.json"
TFLITE = OUT / "model_quantized.tflite"
REPORT = OUT / "model_quantized_report.json"
# The convert verb's defaults, which the fixture was made with.
SEED, PER_CLASS, NUM_SAMPLES, VALIDATE_SAMPLES, MIN_COSINE = 42, 10, 100, 64, 0.95
CLASS_ACTIVATION = "softmax"
# The seeded WAV folder: a folder per flagship class plus a noise folder,
# TRAIN_FILES mono PCM16 files at 22.05 kHz of 4-7 s each. chip_smoke.py's
# train, evaluate and convert phases use it too.
TRAIN_FILES = 3


def write_train_folder(root: Path, class_names: list[str]) -> None:
    """One chirp-and-tone pattern per class (its own base frequency and
    sweep) with noise; the noise folder holds noise only."""
    from birdnet_stm32_tpu_torch.audio.io import save_wav

    sr = 22050
    rng = np.random.default_rng(8)
    t = np.arange(7 * sr, dtype=np.float32) / np.float32(sr)
    gate = np.sin(2 * np.pi * 2.0 * t) > 0
    for ci, name in enumerate([*class_names, "noise"]):
        f0 = np.float32(300.0 + 45.0 * ci)
        if ci < len(class_names):
            pattern = (0.4 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.05 * (ci % 7) * t))
                       + 0.2 * np.sin(2 * np.pi * 1.5 * f0 * t) * gate)
            sigma = np.float32(0.05)
        else:
            pattern, sigma = np.zeros_like(t), np.float32(0.3)
        for i in range(TRAIN_FILES):
            n = int(sr * rng.uniform(4.0, 7.0))
            x = pattern[:n] + sigma * rng.standard_normal(n, dtype=np.float32)
            save_wav(x, root / name / f"{i}.wav", sr)


def load_state_dict() -> dict:
    """The committed weights as a state_dict of CPU tensors."""
    import torch

    with np.load(OUT / "state_dict.npz") as d:
        return {k: torch.from_numpy(d[k]) for k in d.files}


def load_model(device: str = "cpu"):
    """(DSCNN with the committed weights on `device`, its ModelConfig)."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    cfg = ModelConfig.load(OUT / "model_config.json")
    model = build_dscnn(cfg, class_activation=CLASS_ACTIVATION, device=device)
    model.load_state_dict(load_state_dict(), strict=True)
    return model, cfg


def calibration_inputs(data: Path, cfg, device: str) -> np.ndarray:
    """The verb's calibration features of the WAV folder `data` on `device`:
    stratified sampling, then representative_inputs."""
    from birdnet_stm32_tpu_torch.data.dataset import load_file_paths_from_directory
    from birdnet_stm32_tpu_torch.quant.calibrate import (
        representative_inputs,
        stratified_sample_paths,
    )

    paths, labels, _ = load_file_paths_from_directory(data, classes=cfg.class_names)
    paths = stratified_sample_paths(paths, labels, PER_CLASS, SEED)
    return representative_inputs(paths, cfg, num_samples=NUM_SAMPLES, seed=SEED,
                                 device=device)


def validation_subset(x: np.ndarray) -> np.ndarray:
    """The inputs convert_model's single validation seed draws from `x`."""
    return x[np.random.default_rng(SEED).permutation(len(x))[:VALIDATE_SAMPLES]]


def _gate_bites(model, cfg, data: Path) -> None:
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner
    from birdnet_stm32_tpu_torch.quant.validate import cosine_similarity

    x = validation_subset(calibration_inputs(data, cfg, "cpu"))
    y = TorchRunner(model, cfg, device="cpu").predict(x)
    perm = np.random.default_rng(0).permutation(y.shape[1])
    for name, other in (("constant", np.full_like(y, y.mean())), ("shuffled", y[:, perm])):
        cos = float(np.mean([cosine_similarity(a, b) for a, b in zip(y, other)]))
        print(f"{name} scores: mean cosine {cos:.4f} against the float scores")
        assert cos < MIN_COSINE, f"the cosine gate does not bite: {name} reads {cos}"


def main() -> None:
    from birdnet_stm32_tpu_torch.__main__ import main as verb
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.training.checkpoint import save_checkpoint, save_train_state

    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    model = init_model(build_dscnn(cfg, class_activation=CLASS_ACTIVATION, device="cpu"),
                       seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        data, run = Path(tmp) / "data", Path(tmp) / "run"
        write_train_folder(data, cfg.class_names)
        _gate_bites(model, cfg, data)
        save_checkpoint(run, model.state_dict(), cfg)
        save_train_state(run, 1, multilabel=False)  # the softmax head
        if OUT.exists():
            shutil.rmtree(OUT)
        OUT.mkdir(parents=True)
        np.savez(OUT / "state_dict.npz",
                 **{k: v.numpy() for k, v in model.state_dict().items()})
        cfg.save(OUT / "model_config.json")
        shutil.copy(run / "labels.txt", OUT / "labels.txt")
        # Relative paths, so the report names no absolute directory.
        rc = verb(["convert", "--model_path", str(run), "--data_path", str(data),
                   "--output_path", str(TFLITE.relative_to(ROOT)), "--no_npz",
                   "--device", "cpu"])
        assert rc == 0, rc
    report = json.loads(REPORT.read_text())
    print(json.dumps(report["validation"]))
    for p in sorted(OUT.iterdir()):
        print(f"{p.relative_to(ROOT)}: {p.stat().st_size:,} B")


if __name__ == "__main__":
    import os

    os.chdir(ROOT)
    main()
