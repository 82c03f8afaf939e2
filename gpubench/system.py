"""The system under test: the port's fused classifier
(birdnet_stm32_tpu_torch/models/serving.py::make_fused_classifier) for a
configuration and a traffic mix. This is the one module of the benchmark
that imports the port.

A configuration's `runner` says which of the port's runners serves it:
- "tflite_sim": TFLiteSimRunner over the configuration's .tflite file (the
  bit-exact integer executor);
- "torch": the model that the configuration's `builder` makes
  ("birdnet_stm32_tpu_torch.<module>:<function>", called as
  `builder(cfg, class_activation=..., device=...)`), with the harness's
  seeded weights, served by TorchRunner in the configuration's
  `precision`.
With more than one card the runner gets the cards as its mesh.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from pathlib import Path

import torch

from gpubench.weights import seeded_state

PORT = "birdnet_stm32_tpu_torch"
PRECISIONS = {"float32": None, "bfloat16": torch.bfloat16}


@dataclass
class System:
    classify: object
    weights: dict | None = None  # the harness's float32 weights (CPU), for the reference


def builder(path: str):
    """The callable a configuration's `builder` names: a function of a
    module of the port."""
    module, _, attr = path.partition(":")
    if not module.startswith(PORT + ".") or not attr:
        raise ValueError(f"builder {path!r}: not {PORT}.<module>:<function>")
    fn = getattr(importlib.import_module(module), attr, None)
    if not callable(fn):
        raise ValueError(f"builder {path!r}: {module} has no function {attr!r}")
    return fn


def build(config: dict, mix: dict, seed: int, devices: list, root: Path) -> System:
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier

    cfg = ModelConfig.from_dict(config)
    mesh = devices if len(devices) > 1 else None
    dev = devices[0]
    weights = None
    if config["runner"] == "tflite_sim":
        runner = TFLiteSimRunner(root / config["tflite"], device=dev, mesh=mesh)
    elif config["runner"] == "torch":
        model = builder(config["builder"])(cfg, class_activation=config["class_activation"],
                                           device=dev)
        state = seeded_state(model.state_dict(), config, seed, dev)
        model.load_state_dict(state, strict=False)
        weights = {k: v.detach().float().cpu() for k, v in state.items()}
        runner = TorchRunner(model, cfg, device=dev, dtype=PRECISIONS[config["precision"]],
                             mesh=mesh)
        del model, state
    else:
        raise ValueError(f"unknown runner {config['runner']!r}")
    rate = mix.get("input_rate")
    classify = make_fused_classifier(
        runner, cfg, input_sample_rate=rate if rate and rate != cfg.sample_rate else None,
        as_numpy=True, input_dtype=mix["input_dtype"], device=dev)
    return System(classify, weights)
