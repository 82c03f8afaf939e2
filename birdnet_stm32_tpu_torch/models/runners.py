"""Model runners: one predict() API over the float model (float32 or
bf16), the INT8 integer graph and the TFLite interpreter (port of
models/runners.py), and load_model_runner, which picks one from a model
file.

Reference .keras archives (models/transplant.py) and run directories the
port's `train` wrote load as TorchRunners.

The two device-side runners take `mesh=`, as the JAX runners do: a list of
local devices (parallel/mesh.py::local_mesh; it may name one device more
than once). Parameters are replicated on each distinct device, each batch
is split into equal row blocks in mesh order, and the scores are gathered
back in row order on mesh[0], the runner's `device`.
"""

from __future__ import annotations

import copy
import functools
import sys
from pathlib import Path

import numpy as np
import torch

from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.models.blocks import ACT_FQ, opens_spans
from birdnet_stm32_tpu_torch.parallel.mesh import gather, local_mesh, shard_batch
from birdnet_stm32_tpu_torch.parallel.steps import infer_block, make_infer_fn
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    REQUANT_MODES,
    TFLiteGraph,
    build_executor,
)
from birdnet_stm32_tpu_torch.utils.tracing import GRAPH, TORCH_GRAPH, span


def _mesh_and_device(mesh, device) -> tuple[list[torch.device] | None, torch.device]:
    """(the mesh or None, the runner's device): without a mesh `device`
    (default CUDA); with one mesh[0], which `device`, when given, must name."""
    if mesh is None:
        return None, resolve_device("cuda" if device is None else device)
    mesh = local_mesh(mesh)
    if device is not None and resolve_device(device) != mesh[0]:
        raise ValueError(f"device {device} is not the mesh's first device {mesh[0]}")
    return mesh, mesh[0]


def _host_scores(runner, x_batch: np.ndarray) -> np.ndarray:
    """A runner's scores of host features, each row block copied to its
    device and its scores straight back to the host."""
    x = torch.as_tensor(np.asarray(x_batch, np.float32))
    blocks = shard_batch(x, runner.mesh or [runner.device])
    return np.concatenate([runner.forward_block(b).cpu().numpy() for b in blocks])


class TorchRunner:
    """Float forward of a model (the DS-CNN, EfficientNet-B1) on one
    device (default CUDA; raises if there is none) or over a local mesh
    (`mesh=`, module docstring). The model is moved to `device` (mesh[0])
    and put in eval mode; under a mesh each other distinct device gets a
    deep copy (`replicas`).

    dtype=torch.bfloat16 serves in bf16, as the JAX FlaxRunner(dtype=...):
    a copy of the model gets every floating parameter and buffer (the BN
    running statistics too) in bf16, and so does each replica; features go
    in as bf16 and the scores come out float32. The model passed in is left
    as it is. A device that refuses a bf16 op raises; nothing falls back to
    float32.

    On a CUDA device each row block's eval forward (forward_block, and so
    forward under a mesh) is replayed as one CUDA graph per (batch size,
    input dtype, card), kept for the runner's life (_GraphedCall): its
    first call runs eagerly and captures one call, every later call
    replays the same kernels on the same values from one host call,
    bit-equal to the eager forward on that card, and returns a clone of
    the graph's output. Each graph keeps its own memory pool reserved for
    the runner's life: about 61 MB at 64 flagship rows in bf16 on an H100,
    where an eager call peaks at about 80 MB. A block stays eager on the
    CPU, while the activation fake-quant hook is set (a capture would
    freeze the Python callable, quant/fake_quant.py::activation_fake_quant),
    and for a model whose layers open program spans of their own
    (models/blocks.py::opens_spans: EfficientNet's MBConv blocks, whose
    mbconv.* spans a replay would leave empty). make_embedder calls the
    replicas eagerly.
    """

    def __init__(self, model: torch.nn.Module, cfg=None,
                 device: str | torch.device | None = None, dtype: torch.dtype | None = None,
                 mesh=None):
        self.mesh, self.device = _mesh_and_device(mesh, device)
        if dtype is not None:
            model = copy.deepcopy(model).to(dtype)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.dtype = dtype
        self.replicas = make_infer_fn(self.model, self.mesh, dtype).replicas
        self.graphable = not opens_spans(self.model)
        self._graphs: dict[tuple[int, torch.dtype, torch.device], _GraphedCall] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, bins, W, 1] features on self.device -> [B, C] float32 scores
        there (under a mesh B must divide over it)."""
        return gather([self.forward_block(b) for b in shard_batch(x, self.mesh or [self.device])],
                      self.device)

    def forward_block(self, x: torch.Tensor) -> torch.Tensor:
        """The scores of rows on one device of the mesh, by its replica:
        on a card, by the replay of its CUDA graph (class docstring)."""
        if not self.graphs_engage(x.device):
            return infer_block(self.replicas, x, self.dtype)
        key = (x.shape[0], x.dtype, x.device)
        if key not in self._graphs:
            self._graphs[key] = _GraphedCall(
                functools.partial(infer_block, self.replicas, dtype=self.dtype), key,
                TORCH_GRAPH, "TorchRunner forward", "(batch, input dtype, device)")
        return self._graphs[key](x)

    def graphs_engage(self, device: torch.device) -> bool:
        """Whether a block on `device` is served by a CUDA graph now."""
        return device.type == "cuda" and self.graphable and ACT_FQ.get() is None

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        return _host_scores(self, x_batch)


class TFLiteSimRunner:
    """INT8 integer-graph executor of a .tflite flatbuffer on one device
    (default CUDA; raises if there is none) or over a local mesh (`mesh=`,
    module docstring), bit-exact with the JAX package's. One executor is
    built per (batch size, entry form, device) and kept; callers should
    batch uniformly (pad the tail). Under a mesh each shard runs the
    executor of its device at the shard's batch size; an executor holds
    its graph's constants and no state between calls.

    On a CUDA device the kept executor is a CUDA graph of the eager one
    (_GraphedExecutor): its first call runs eagerly and captures one call,
    every later call replays the same kernels on the same values from one
    host call, bit-equal, and returns a clone of the graph's output, so an
    answer a caller holds (or another row block on the same card) is never
    overwritten by the next replay. Each graph keeps its own memory pool
    reserved for the runner's life: about 400 MB at 64 flagship rows on an
    H100, where an eager call peaks at about 290 MB. On the CPU, and where
    `build_executor` is called directly (return_all, torch.export), the
    executor stays eager."""

    def __init__(self, tflite: str | Path | bytes | TFLiteGraph,
                 device: str | torch.device | None = None, requant: str = "exact", mesh=None):
        if requant not in REQUANT_MODES:
            raise ValueError(f"Invalid requant: {requant!r} (expected one of {REQUANT_MODES})")
        self.mesh, self.device = _mesh_and_device(mesh, device)
        self.graph = tflite if isinstance(tflite, TFLiteGraph) else TFLiteGraph(tflite)
        self.requant = requant
        self._executors: dict[tuple[int, bool, torch.device], callable] = {}

    def executor(self, batch_size: int, prequantized_input: bool = False,
                 device: torch.device | None = None):
        """The executor for `batch_size` on `device` (default self.device);
        with prequantized_input it takes the int8 entry tensor
        [B, 1, W, bins] (frontend_input(quant=...)). On a CUDA device it
        is the executor's CUDA graph (class docstring)."""
        device = self.device if device is None else device
        key = (batch_size, prequantized_input, device)
        if key not in self._executors:
            fwd = build_executor(self.graph, batch_size, device=device, requant=self.requant,
                                 prequantized_input=prequantized_input)
            self._executors[key] = _GraphedExecutor(fwd, key) if device.type == "cuda" else fwd
        return self._executors[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Graph-input features [B, ...] float32 on self.device -> scores
        there (under a mesh B must divide over it)."""
        return gather([self.forward_block(b) for b in shard_batch(x, self.mesh or [self.device])],
                      self.device)

    def forward_block(self, x: torch.Tensor) -> torch.Tensor:
        """The scores of rows on one device of the mesh, by its executor."""
        return self.executor(x.shape[0], device=x.device)(x)

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        return _host_scores(self, x_batch)


class _GraphedCall:
    """A device call (an integer executor, a model's eval forward) replayed
    as one CUDA graph for one key (batch size, input form, card).

    The first call runs the eager call on a side stream of the key's card,
    which checks its input and readies cuDNN, cuBLAS and the allocator, and
    returns that answer; then one call is captured into a CUDA graph on the
    same stream, from a static input buffer allocated before the capture.
    Every later call checks x's shape, dtype and device, copies it into
    that buffer, replays the graph and returns a clone of its output. While
    a profiler records, the copy, replay and clone run in one span
    `span_name` (utils/tracing.py). If the capture raises, the key keeps
    the eager call from then on, which is said once on stderr under
    `label`, with the key described by `key_names`.

    A call runs on the caller's current stream, so answers held across
    calls are safe; the input buffer is shared, so one thread at a time
    calls a key (every caller in the port classifies on one thread)."""

    def __init__(self, eager, key: tuple, span_name: str, label: str, key_names: str):
        self.eager = eager
        self.key = key
        self.span_name, self.label, self.key_names = span_name, label, key_names
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_in = self.static_out = None
        self.eager_only = False

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is not None:
            return self._replay(x)
        if self.eager_only:
            return self.eager(x)
        return self._capture(x)

    def _replay(self, x: torch.Tensor) -> torch.Tensor:
        s = self.static_in
        # copy_ would broadcast a wrong shape silently: check first.
        if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
            raise ValueError(f"{self.label} for {tuple(s.shape)} {s.dtype} on {s.device} got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        with span(self.span_name):
            s.copy_(x)
            self.graph.replay()
            return self.static_out.clone()

    def _capture(self, x: torch.Tensor) -> torch.Tensor:
        dev = self.key[2]
        with torch.cuda.device(dev):
            caller, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                out = self.eager(x)
            caller.wait_stream(side)
            static_in = torch.empty(x.shape, dtype=x.dtype, device=dev)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side):
                    static_out = self.eager(static_in)
            except RuntimeError as e:
                self.eager_only = True
                print(f"[warn] {self.label}: CUDA graph capture failed for {self.key_names} "
                      f"{self.key}: {e!r}; this key runs eagerly", file=sys.stderr)
                return out
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        return out


class _GraphedExecutor(_GraphedCall):
    """An integer executor (build_executor) as a _GraphedCall for the key
    (batch size, prequantized entry, card), its span tflite.GRAPH; `steps`
    is the eager executor's."""

    def __init__(self, eager, key: tuple[int, bool, torch.device]):
        super().__init__(eager, key, GRAPH, "TFLiteSimRunner executor",
                         "(batch, prequantized, device)")
        self.steps = eager.steps


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
                      device: str | torch.device = "cuda",
                      config_path: str | Path | None = None):
    """The runner for a model file: a .tflite gives TFLiteSimRunner on
    `device` when the graph is full-int8, else TFLiteInterpreterRunner (host);
    a run directory of the port's `train` (or the .keras path train mapped
    to it) gives a TorchRunner of its best/ weights on `device`, with the
    head train_state.json records; a reference .keras archive gives a
    TorchRunner of its transplanted weights (models/transplant.py), with
    `config_path` as its sidecar (default `<stem>_model_config.json` beside
    it). `dtype` (torch.bfloat16 for bf16 serving) applies to float
    checkpoints only; a .tflite ignores it, as in the JAX package.

    A JAX (orbax) run directory raises ValueError
    (training/checkpoint.py::load_checkpoint).
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
        from birdnet_stm32_tpu_torch.models.transplant import load_reference_model

        if config_path is None:
            config_path = p.with_name(p.stem + "_model_config.json")
        model, _, cfg = load_reference_model(p, config_path, device=device)
        return TorchRunner(model, cfg, device=device, dtype=dtype)
    raise ValueError(f"Cannot infer runner type from {model_path}")
