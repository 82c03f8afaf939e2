"""Write the transplant fixture of the PyTorch port, and read it back.

A reference .keras archive of the flagship geometry, for the tests and for
chip_smoke.py's transplant phase. Run from the repository root (h5py; no
JAX, no TensorFlow; a few seconds):

    python -m tests.make_torch_transplant_fixtures

It writes tests/goldens/torch_transplant/:

- birdnet_flagship.keras: the flagship geometry
  (artifacts/flagship/bundle/model_config.json: hybrid, pwl, 100 classes,
  full width, 224,388 parameters) with the port's seeded weights,
  init_model(seed=0), in the Keras 3 layout the reference's saving writes
  (tests/torch_keras_archive.py), softmax head;
- birdnet_flagship_model_config.json: its sidecar (the flagship config),
  the name load_model_runner derives for the archive.

The port's transplant of the archive (models/transplant.py::
transplant_params) is bit for bit the convert fixture's
tests/goldens/torch_convert/state_dict.npz (the same seeded flagship
weights; main() asserts it, and tests/test_torch_transplant.py holds it),
so that file is the transplanted state_dict and is not stored twice. The
card machine has no h5py, so chip_smoke.py serves those weights there,
with the architecture and head read from the archive's config.json
(zipfile and json only).

The helpers below import neither JAX nor h5py at module level. Not
collected by pytest (its name does not start with test_).
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "goldens" / "torch_transplant"
KERAS = OUT / "birdnet_flagship.keras"
SIDECAR = OUT / "birdnet_flagship_model_config.json"
# The transplanted weights (see the module docstring).
STATE_DICT = ROOT / "tests" / "goldens" / "torch_convert" / "state_dict.npz"
FLAGSHIP_CONFIG = ROOT / "artifacts" / "flagship" / "bundle" / "model_config.json"
SEED = 0


def load_state_dict() -> dict:
    """The committed transplanted weights as CPU tensors."""
    import torch

    with np.load(STATE_DICT) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def archive_model(device: str = "cuda"):
    """(model, cfg) of the archive without h5py: the architecture and head
    from its config.json (models/transplant.py::detect_arch), the weights
    from state_dict.npz."""
    import dataclasses

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
    from birdnet_stm32_tpu_torch.models.transplant import detect_arch

    with zipfile.ZipFile(KERAS) as z:
        layers = json.loads(z.read("config.json"))["config"]["layers"]
    arch = detect_arch(layers)
    activation = arch.pop("class_activation", "softmax")
    cfg = dataclasses.replace(ModelConfig.load(SIDECAR), **arch)
    model = build_dscnn(cfg, class_activation=activation, device=device)
    model.load_state_dict(load_state_dict(), strict=True)
    return model, cfg


def main() -> None:
    import shutil

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.convert import state_dict_to_flax
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.models.transplant import transplant_params
    from tests.torch_keras_archive import write_keras_archive

    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    model = init_model(build_dscnn(cfg, device="cpu"), seed=SEED)
    OUT.mkdir(parents=True, exist_ok=True)
    write_keras_archive(KERAS, state_dict_to_flax(model.state_dict()), class_activation="softmax")
    shutil.copy(FLAGSHIP_CONFIG, SIDECAR)
    state_dict, _ = transplant_params(KERAS, cfg)
    ref = load_state_dict()
    assert state_dict.keys() == ref.keys()
    assert all(np.array_equal(state_dict[k].numpy(), ref[k].numpy()) for k in ref), (
        "the transplant differs from tests/goldens/torch_convert/state_dict.npz")
    print(f"wrote {OUT}: " + ", ".join(f"{p.name} {p.stat().st_size:,} B"
                                        for p in sorted(OUT.iterdir())))


if __name__ == "__main__":
    main()
