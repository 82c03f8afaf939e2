"""Model runners: one predict() API over the float model (float32 or
bf16), the INT8 integer graph and the TFLite interpreter (port of
models/runners.py), and load_model_runner, which picks one from a model
file.

Not ported yet (ROADMAP.md, Queue 1): meshes, and loading reference
.keras files (item 3). Run directories the port's `train` wrote load as
TorchRunners.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import full_fp32, resolve_device
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    REQUANT_MODES,
    TFLiteGraph,
    build_executor,
)


class TorchRunner:
    """Float forward of a DSCNN on one device (default CUDA; raises if
    there is none). The model is moved there and put in eval mode.

    dtype=torch.bfloat16 serves in bf16, as the JAX FlaxRunner(dtype=...):
    a copy of the model gets every floating parameter and buffer (the BN
    running statistics too) in bf16, features go in as bf16 and the scores
    come out float32. The model passed in is left as it is. A device that
    refuses a bf16 op raises; nothing falls back to float32.
    """

    def __init__(self, model: torch.nn.Module, cfg=None,
                 device: str | torch.device = "cuda", dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        if dtype is not None:
            model = copy.deepcopy(model).to(dtype)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.dtype = dtype

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, bins, W, 1] features on self.device -> [B, C] float32 scores."""
        with full_fp32():
            if self.dtype is None:
                return self.model(x)
            return self.model(x.to(self.dtype)).float()

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
        if requant not in REQUANT_MODES:
            raise ValueError(f"Invalid requant: {requant!r} (expected one of {REQUANT_MODES})")
        self.device = resolve_device(device)
        self.graph = tflite if isinstance(tflite, TFLiteGraph) else TFLiteGraph(tflite)
        self.requant = requant
        self._executors: dict[tuple[int, bool], callable] = {}

    def executor(self, batch_size: int, prequantized_input: bool = False):
        """The executor for `batch_size`; with prequantized_input it takes
        the int8 entry tensor [B, 1, W, bins] (frontend_input(quant=...))."""
        key = (batch_size, prequantized_input)
        if key not in self._executors:
            self._executors[key] = build_executor(
                self.graph, batch_size, device=self.device, requant=self.requant,
                prequantized_input=prequantized_input)
        return self._executors[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Graph-input features [B, ...] float32 on self.device -> scores."""
        return self.executor(x.shape[0])(x)

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x_batch, np.float32), device=self.device)
        return self.forward(x).cpu().numpy()


class TFLiteInterpreterRunner:
    """The TFLite interpreter on the host, for graphs the integer executor
    does not run (dynamic-range or float exports): builtin ops, no
    delegates, dynamic batch resize. Needs TensorFlow, which it imports
    itself; without it (the port's card machine has none) it raises
    ImportError."""

    def __init__(self, tflite_path: str | Path):
        import tensorflow as tf

        self._path = str(tflite_path)
        self._tf = tf
        self._interp = self._make_interp()
        self._interp.allocate_tensors()

    def _make_interp(self):
        # No delegates: XNNPack refuses to prepare some quantized graphs
        # (REDUCE_MAX / DIV chains) entirely.
        return self._tf.lite.Interpreter(
            model_path=self._path,
            experimental_op_resolver_type=self._tf.lite.experimental.OpResolverType
            .BUILTIN_WITHOUT_DEFAULT_DELEGATES)

    def _invoke(self, x: np.ndarray) -> np.ndarray:
        inp = self._interp.get_input_details()[0]
        if inp["shape"][0] != x.shape[0]:
            self._interp.resize_tensor_input(inp["index"], (x.shape[0], *inp["shape"][1:]))
            self._interp.allocate_tensors()
            inp = self._interp.get_input_details()[0]
        self._interp.set_tensor(inp["index"], x)
        self._interp.invoke()
        return np.asarray(self._interp.get_tensor(self._interp.get_output_details()[0]["index"]))

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        x = np.asarray(x_batch, np.float32)
        try:
            return self._invoke(x)
        except RuntimeError:
            # Some graphs refuse a dynamic batch resize, and a failed
            # AllocateTensors leaves the interpreter unusable: rebuild it,
            # then invoke per sample.
            self._interp = self._make_interp()
            self._interp.allocate_tensors()
            return np.concatenate([self._invoke(x[i : i + 1]) for i in range(x.shape[0])])


def _is_full_int8(graph: TFLiteGraph) -> bool:
    """True when every conv / FC in the graph carries int8 quantization."""
    for op in graph.ops:
        if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            for idx in op.inputs[:2]:
                t = graph.tensors[idx]
                if t.dtype != "int8" or t.scale is None:
                    return False
    return True


def load_model_runner(model_path: str | Path, dtype: torch.dtype | None = None,
                      device: str | torch.device = "cuda"):
    """The runner for a model file: a .tflite gives TFLiteSimRunner on
    `device` when the graph is full-int8, else TFLiteInterpreterRunner (host);
    a run directory of the port's `train` (or the .keras path train mapped
    to it) gives a TorchRunner of its best/ weights on `device`, with the
    head train_state.json records. `dtype` (torch.bfloat16 for bf16
    serving) applies to float checkpoints only; a .tflite ignores it, as in
    the JAX package.

    Reference .keras files raise NotImplementedError (their transplant is
    ROADMAP.md Queue 1 item 3); a JAX (orbax) run directory raises
    ValueError (training/checkpoint.py::load_checkpoint).
    """
    from birdnet_stm32_tpu_torch.training.checkpoint import keras_run_dir, load_checkpoint

    p = Path(model_path)
    if p.suffix == ".tflite":
        sim = TFLiteSimRunner(p, device=device)
        if _is_full_int8(sim.graph):
            return sim
        return TFLiteInterpreterRunner(p)
    run_dir = keras_run_dir(p) if p.suffix == ".keras" else (p if p.is_dir() else None)
    if run_dir is not None:
        model, _, cfg = load_checkpoint(run_dir, device=device)
        return TorchRunner(model, cfg, device=device, dtype=dtype)
    if p.suffix == ".keras":
        raise NotImplementedError(
            f"{model_path}: reference .keras files are not loadable in the port yet "
            "(ROADMAP.md Queue 1 item 3); serve a run directory of the port's train "
            "or a .tflite")
    raise ValueError(f"Cannot infer runner type from {model_path}")
