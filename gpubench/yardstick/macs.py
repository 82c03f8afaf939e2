"""Multiply-accumulates of one chunk through a configuration's model. Each
model's count is its own file here, macs_<model>.py (macs_dscnn.py for the
DS-CNN), with a `model_macs(config)`, found by the configuration's
`model`."""

from __future__ import annotations

from pathlib import Path

from gpubench import load_file

DIR = Path(__file__).resolve().parent


def model_macs(config: dict) -> int:
    """MACs per chunk of the configuration's `model`."""
    return load_file(DIR, f"macs_{config['model']}").model_macs(config)
