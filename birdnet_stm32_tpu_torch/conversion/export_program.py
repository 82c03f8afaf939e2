"""Portable serving module: the full serving function as a torch.export
program (the port's counterpart of conversion/export_stablehlo.py).

StableHLO bytes are a JAX artefact; the portable artefact in PyTorch is an
ExportedProgram saved with torch.export.save (a `.pt2` file). One program
holds the frontend and the model (or the bit-exact INT8 integer graph),
with a static batch baked in as the JAX export does, and loads with
torch.export.load where this package is not installed.

The frontend inside the program is the composition of plain PyTorch
operations (ops/frontend.py::inputs_for_config), not the hand-written
frontend kernel: the program must run where the port is not installed,
and a ctypes kernel launch cannot be traced. So a loaded program launches
no frontend kernel. The program runs in float32 exactly as traced: the
caller's TF32 flags do not reach it, because load_serving_fn runs it
inside device.full_fp32().
"""

from __future__ import annotations

import io
from pathlib import Path

import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config


class _Serving(torch.nn.Module):
    """waveform [B, T] -> scores through `forward_fn`, or features ->
    scores when the frontend is left out."""

    def __init__(self, forward_fn, cfg: ModelConfig, include_frontend: bool):
        super().__init__()
        self.forward_fn = forward_fn
        self.cfg = cfg
        self.include_frontend = include_frontend

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.include_frontend:
            x = inputs_for_config(x, self.cfg)
        return self.forward_fn(x)


def _export(module: torch.nn.Module, shape: tuple[int, ...], dev: torch.device) -> bytes:
    example = torch.zeros(shape, dtype=torch.float32, device=dev)
    with full_fp32(), torch.no_grad():
        # One eager call first: the frontend's tables are lru-cached per
        # device on first use, and a first use inside the trace would cache
        # the tracer's fake tensors for every later eager call.
        module(example)
        program = torch.export.export(module, (example,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_serving_fn(model: torch.nn.Module, cfg: ModelConfig, batch_size: int = 64,
                      include_frontend: bool = True,
                      device: str | torch.device = "cuda") -> bytes:
    """waveform [batch_size, chunk_samples] -> scores (or, with
    include_frontend=False, model-input features -> scores) as saved
    torch.export program bytes. The model (any class_activation) is moved
    to `device` (default CUDA; raises if there is none) in eval mode."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    shape = ((batch_size, cfg.chunk_samples) if include_frontend
             else (batch_size, *cfg.input_shape()))
    return _export(_Serving(model, cfg, include_frontend), shape, dev)


def export_int8_serving_fn(tflite_path: str | Path, cfg: ModelConfig, batch_size: int = 64,
                           device: str | torch.device = "cuda") -> bytes:
    """waveform [batch_size, chunk_samples] -> the INT8 integer executor's
    scores (quant/tflite_import.py::build_executor, bit-exact) as saved
    torch.export program bytes. On a card the executor's int8 convolution
    kernels take their plain steps while it is traced, so the program holds
    no kernel launch and computes the same codes: a custom op would tie
    the program to this package, which must not be needed to load it. So
    the loaded program runs the convolutions as the plain steps, slower on
    a card than the executor that serves."""
    from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor

    dev = resolve_device(device)
    fwd = build_executor(TFLiteGraph(str(tflite_path)), batch_size, device=dev)
    return _export(_Serving(fwd, cfg, True), (batch_size, cfg.chunk_samples), dev)


def load_serving_fn(data: bytes):
    """A callable of the saved program: f(x) -> scores, run without
    autograd and in full float32 (no TF32) on the device it was exported
    on."""
    module = torch.export.load(io.BytesIO(data)).module()

    def run(*args):
        with full_fp32(), torch.no_grad():
            return module(*args)

    return run
