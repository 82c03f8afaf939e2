"""The system under test: the port's fused classifier
(birdnet_stm32_tpu_torch/models/serving.py::make_fused_classifier) for a
configuration and a traffic mix. This is the one module of the benchmark
that imports the port.

A configuration's `runner` says which of the port's runners serves it:
- "tflite_sim": TFLiteSimRunner over the configuration's .tflite file (the
  bit-exact integer executor);
- "torch": build_dscnn with the harness's seeded weights, served by
  TorchRunner in the configuration's `precision`.
With more than one card the runner gets the cards as its mesh.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path

import torch

from gpubench.weights import seeded_state

PRECISIONS = {"float32": None, "bfloat16": torch.bfloat16}


@dataclass
class System:
    classify: object
    runner: object
    devices: list
    weights: dict | None = None  # the harness's float32 weights (CPU), for the reference

    @contextlib.contextmanager
    def model_span(self, name: str = "gpubench.model"):
        """Wrap the runner's per-block model call in a profiler span (traced
        runs only); restores the runner afterwards."""
        from torch.profiler import record_function

        r = self.runner
        if hasattr(r, "graph"):
            make = r.executor

            def executor(*a, **k):
                fwd = make(*a, **k)

                def spanned(x):
                    with record_function(name):
                        return fwd(x)
                return spanned
            r.executor = executor
        else:
            block = r.forward_block

            def forward_block(x):
                with record_function(name):
                    return block(x)
            r.forward_block = forward_block
        try:
            yield
        finally:
            for attr in ("executor", "forward_block"):
                r.__dict__.pop(attr, None)


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
        from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

        model = build_dscnn(cfg, class_activation=config["class_activation"], device=dev)
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
    return System(classify, runner, devices, weights)
