"""Sidecar paths of a model file (port of cli/deploy.py::derive_sidecar_paths
and resolve_config_path; packaging a bundle is not ported yet)."""

from __future__ import annotations

from pathlib import Path


def derive_sidecar_paths(model_path: str) -> tuple[str, str]:
    """(config path, labels path) derived from a model path: strip the
    extension and a `_quantized` suffix, then append `_model_config.json` /
    `_labels.txt`. Directory checkpoints hold their sidecars inside."""
    p = Path(model_path)
    if p.is_dir():
        return str(p / "model_config.json"), str(p / "labels.txt")
    root = str(p.with_suffix("")).replace("_quantized", "")
    cfg = root + "_model_config.json"
    if not Path(cfg).exists():
        if (p.parent / "model_config.json").exists():
            # A .tflite inside a run directory or bundle
            # (run/model_quantized.tflite next to run/model_config.json).
            return str(p.parent / "model_config.json"), str(p.parent / "labels.txt")
        if (Path(root) / "model_config.json").exists():
            # `<run>_quantized.tflite` exported next to the run directory.
            return str(Path(root) / "model_config.json"), str(Path(root) / "labels.txt")
    return cfg, root + "_labels.txt"


def resolve_config_path(model_path, config_path=None):
    """An explicit config_path wins; otherwise the derived sidecar when it
    exists on disk, else None."""
    if config_path:
        return str(config_path)
    cfg, _ = derive_sidecar_paths(str(model_path))
    return cfg if Path(cfg).exists() else None
