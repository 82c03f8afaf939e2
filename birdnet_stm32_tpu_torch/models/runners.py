"""Model runner: one predict() API over the float model (port of
models/runners.py::FlaxRunner).

float32 only; the bf16 runner and the INT8 integer-graph runner wait for
later slices (ROADMAP.md, Queue 1 items 3-6).
"""

from __future__ import annotations

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device


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
