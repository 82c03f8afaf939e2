"""Model runners: one predict() API over the float model and the INT8
integer graph (port of models/runners.py::FlaxRunner and TFLiteSimRunner).

Not ported yet (ROADMAP.md, Queue 1): the bf16 runner, meshes,
TFLiteInterpreterRunner and load_model_runner.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor


class TorchRunner:
    """Float32 forward of a DSCNN on one device (default CUDA; raises if
    there is none). The model is moved there and put in eval mode."""

    def __init__(self, model: torch.nn.Module, cfg=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, bins, W, 1] features on self.device -> [B, C] scores."""
        with full_fp32():
            return self.model(x)

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x_batch, np.float32), device=self.device)
        return self.forward(x).cpu().numpy()


class TFLiteSimRunner:
    """INT8 integer-graph executor of a .tflite flatbuffer on one device
    (default CUDA; raises if there is none), bit-exact with the JAX
    package's. One executor is built per batch size (and entry form) and
    kept; callers should batch uniformly (pad the tail)."""

    def __init__(self, tflite: str | Path | bytes | TFLiteGraph,
                 device: str | torch.device = "cuda", requant: str = "exact"):
        if requant != "exact":
            raise NotImplementedError(f"requant={requant!r} is not ported yet "
                                      "(ROADMAP.md, Queue 1: requant='fast')")
        self.device = resolve_device(device)
        self.graph = tflite if isinstance(tflite, TFLiteGraph) else TFLiteGraph(tflite)
        self._executors: dict[tuple[int, bool], callable] = {}

    def executor(self, batch_size: int, prequantized_input: bool = False):
        """The executor for `batch_size`; with prequantized_input it takes
        the int8 entry tensor [B, 1, W, bins] (frontend_input(quant=...))."""
        key = (batch_size, prequantized_input)
        if key not in self._executors:
            self._executors[key] = build_executor(
                self.graph, batch_size, device=self.device,
                prequantized_input=prequantized_input)
        return self._executors[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Graph-input features [B, ...] float32 on self.device -> scores."""
        return self.executor(x.shape[0])(x)

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x_batch, np.float32), device=self.device)
        return self.forward(x).cpu().numpy()
