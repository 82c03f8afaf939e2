"""End-to-end conversion: a trained model -> TFLite + gate + report (port
of conversion/pipeline.py).

Stratified calibration sampling, INT8 PTQ (or dynamic-range, or float),
validation over one or more seeded subsets keeping the worst, a hard
mean-cosine gate, a validation-sample NPZ and a JSON report with the
compression ratio. Validation runs the exported flatbuffer through the
port's bit-exact integer executor (TFLiteSimRunner) against the float model
(TorchRunner), both on the caller's device; only the export needs
TensorFlow.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.conversion.export_tflite import convert_to_tflite
from birdnet_stm32_tpu_torch.models.convert import state_dict_to_flax
from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
from birdnet_stm32_tpu_torch.quant.calibrate import (
    random_representative_inputs,
    representative_inputs,
    stratified_sample_paths,
)
from birdnet_stm32_tpu_torch.quant.validate import validate_runners
from birdnet_stm32_tpu_torch.utils.logging import info, ok, warn


def convert_model(
    model: torch.nn.Module,
    state_dict: dict,
    cfg: ModelConfig,
    out_path: str | Path,
    calibration_paths: list[str] | None = None,
    calibration_labels: list[str] | None = None,
    calibration_per_class: int = 10,
    num_calibration_samples: int = 100,
    calibration_inputs: np.ndarray | None = None,
    validation_inputs: np.ndarray | None = None,
    quantize: str = "int8",
    per_channel: bool = True,
    min_cosine_sim: float = 0.95,
    num_validation_seeds: int = 1,  # clamped to >= 1
    num_validation_samples: int = 64,
    save_npz: bool = True,
    class_activation: str | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    """Convert a trained DSCNN to TFLite with the quality gate.

    Args:
        model, state_dict, cfg: The trained model (the port's DSCNN), its
            weights and its config. The float runner serves `model` on
            `device`; the export reads `state_dict` in the Flax layouts.
        out_path: Destination .tflite path.
        calibration_paths / calibration_labels: Audio files (and their
            class labels, for stratified sampling) for the calibration
            features, computed on `device`.
        calibration_inputs: Pre-built [N, ...] calibration tensors (no
            audio path).
        validation_inputs: [N, ...] tensors for the cosine gate; defaults
            to the calibration inputs.
        quantize: 'int8' | 'dynamic' | 'float'.
        min_cosine_sim: Hard gate on the mean cosine.
        num_validation_seeds: Repeat validation on shuffled subsets and
            keep the worst aggregate.
        device: Where calibration features and both runners run (default
            CUDA; raises without one).

    Returns:
        The report dict (also written beside the artifact as *_report.json).

    Raises:
        RuntimeError: When the mean cosine gate fails (or is NaN).
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    if class_activation is None:
        # The model's own head: exporting softmax onto a sigmoid (multilabel)
        # model would gate mismatched output spaces.
        class_activation = getattr(model, "class_activation", "softmax")

    if calibration_inputs is None and quantize == "int8":
        # Only full-INT8 PTQ consumes calibration data.
        if not calibration_paths:
            warn("convert", "no calibration audio provided; generating a "
                            "random representative dataset")
            calibration_inputs = random_representative_inputs(
                cfg, num_samples=num_calibration_samples, seed=seed)
        else:
            if calibration_labels is not None:
                calibration_paths = stratified_sample_paths(
                    calibration_paths, calibration_labels, calibration_per_class, seed)
            calibration_inputs = representative_inputs(
                calibration_paths, cfg, num_samples=num_calibration_samples, seed=seed,
                device=device)
    if calibration_inputs is not None:
        info("convert", f"{len(calibration_inputs)} calibration samples, mode={quantize}")

    tflite_bytes = convert_to_tflite(
        state_dict_to_flax(state_dict), cfg, representative=calibration_inputs,
        quantize=quantize, class_activation=class_activation, per_channel=per_channel)
    out_path.write_bytes(tflite_bytes)
    ok("convert", f"wrote {out_path} ({len(tflite_bytes):,} B)")

    if validation_inputs is None:
        validation_inputs = calibration_inputs  # None in dynamic / float modes (no gate)
    float_runner = TorchRunner(model, cfg, device=device)
    quant_runner = TFLiteSimRunner(out_path, device=device) if quantize == "int8" else None

    report: dict = {
        "model_path": str(out_path),
        "quantize": quantize,
        "class_activation": class_activation,
        "tflite_bytes": len(tflite_bytes),
        # The trainable parameters (the Flax 'params' collection; no BN
        # statistics).
        "float32_bytes": 4 * sum(p.numel() for p in model.parameters()),
    }
    report["compression_ratio"] = report["float32_bytes"] / max(1, report["tflite_bytes"])

    if quant_runner is not None:
        rng = np.random.default_rng(seed)
        worst: dict | None = None
        for s in range(max(1, num_validation_seeds)):
            idx = rng.permutation(len(validation_inputs))[:num_validation_samples]
            stats = validate_runners(float_runner, quant_runner, validation_inputs[idx])
            info("convert", f"validation seed {s}: cosine_mean={stats['cosine_mean']:.4f} "
                            f"min={stats['cosine_min']:.4f}")
            if worst is None or stats["cosine_mean"] < worst["cosine_mean"]:
                worst = stats
        report["validation"] = worst

        if save_npz:
            # Pad 25 to a batch size validation already built an executor for.
            keep = validation_inputs[:25]
            b = min(32, num_validation_samples, len(validation_inputs))
            padded = np.concatenate(
                [keep, np.zeros((max(0, b - len(keep)), *keep.shape[1:]),
                                keep.dtype)]) if len(keep) < b else keep
            npz_path = out_path.with_name(out_path.stem + "_validation_data.npz")
            np.savez_compressed(
                npz_path, inputs=keep,
                float_outputs=float_runner.predict(padded)[: len(keep)],
                quant_outputs=quant_runner.predict(padded)[: len(keep)])
            report["validation_npz"] = str(npz_path)

        if not np.isfinite(worst["cosine_mean"]) or worst["cosine_mean"] < min_cosine_sim:
            # NaN (an empty validation set) fails too: 'NaN < x' is False.
            raise RuntimeError(
                f"quantization quality gate failed: mean cosine "
                f"{worst['cosine_mean']:.4f} < {min_cosine_sim}")
        ok("convert", f"cosine gate passed: {worst['cosine_mean']:.4f} >= {min_cosine_sim}")
    else:
        warn("convert", "no INT8 validation (mode != int8)")

    report["seconds"] = time.perf_counter() - t0
    report_path = out_path.with_name(out_path.stem + "_report.json")
    report_path.write_text(json.dumps(report, indent=2))
    report["report_path"] = str(report_path)
    return report
