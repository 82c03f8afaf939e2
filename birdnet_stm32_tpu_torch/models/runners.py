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
back in row order on mesh[0], the runner's `device`. Their forward_block
is the serving path's model call; its calls open spans (utils/tracing.py).
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
from birdnet_stm32_tpu_torch.parallel.mesh import gather, local_mesh, replicated, shard_batch
from birdnet_stm32_tpu_torch.parallel.steps import infer_block
from birdnet_stm32_tpu_torch.quant.tflite_import import (
    REQUANT_MODES,
    TFLiteGraph,
    build_executor,
    entry_quant_params,
    entry_transpose_perm,
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


class _DeviceRunner:
    """What the two device runners share: the mesh, forward over it,
    predict on host arrays, and one call kept per key (batch size, input
    form, card): the eager call or, where graphs engage on the key's card,
    its _GraphedCall. A subclass gives forward_block and _GRAPH, the span,
    label and key names of its _GraphedCall."""

    _GRAPH: tuple[str, str, str]

    def __init__(self, mesh, device):
        self.mesh, self.device = _mesh_and_device(mesh, device)
        self._calls: dict[tuple, object] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Model-input features [B, ...] on self.device -> [B, C] float32
        scores there (under a mesh B must divide over it)."""
        return gather([self.forward_block(b) for b in shard_batch(x, self.mesh or [self.device])],
                      self.device)

    def predict(self, x_batch: np.ndarray) -> np.ndarray:
        """Host features -> host scores, each row block copied to its
        device and its scores straight back to the host."""
        x = torch.as_tensor(np.asarray(x_batch, np.float32))
        blocks = shard_batch(x, self.mesh or [self.device])
        return np.concatenate([self.forward_block(b).cpu().numpy() for b in blocks])

    def graphs_engage(self, device: torch.device) -> bool:
        """Whether a block on `device` is served by a CUDA graph now."""
        return device.type == "cuda"

    def _kept(self, key: tuple, build):
        """The call kept for key (batch size, input form, card): build()'s
        eager call, made once, as a _GraphedCall where graphs engage."""
        if key not in self._calls:
            call = build()
            if self.graphs_engage(key[2]):
                call = _GraphedCall(call, key, *self._GRAPH)
            self._calls[key] = call
        return self._calls[key]


class TorchRunner(_DeviceRunner):
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
    input dtype, card), kept for the runner's life (_GraphedCall) and
    bit-equal to the eager forward on that card. Each graph keeps its own
    memory pool reserved for the runner's life: about 61 MB at 64 flagship
    rows in bf16 on an H100, where an eager call peaks at about 80 MB. A
    block stays eager on the CPU, while the activation fake-quant hook is
    set (a capture would freeze the Python callable,
    quant/fake_quant.py::activation_fake_quant), and for a model whose
    layers open program spans of their own (models/blocks.py::opens_spans:
    EfficientNet's MBConv blocks, whose mbconv.* spans a replay would leave
    empty). make_embedder calls the replicas eagerly. Features always
    enter as floats: `entry_quant` is None.
    """

    _GRAPH = (TORCH_GRAPH, "TorchRunner forward", "(batch, input dtype, device)")
    entry_quant = None

    def __init__(self, model: torch.nn.Module, cfg=None,
                 device: str | torch.device | None = None, dtype: torch.dtype | None = None,
                 mesh=None):
        super().__init__(mesh, device)
        if dtype is not None:
            model = copy.deepcopy(model).to(dtype)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.dtype = dtype
        self.replicas = replicated(self.model, self.mesh or [self.device])
        self.graphable = not opens_spans(self.model)

    def forward_block(self, x: torch.Tensor) -> torch.Tensor:
        """The scores of rows on one device of the mesh, by its replica:
        on a card, by the replay of its CUDA graph (class docstring)."""
        if not self.graphs_engage(x.device):
            return infer_block(self.replicas, x, self.dtype)
        return self._kept((x.shape[0], x.dtype, x.device), lambda: functools.partial(
            infer_block, self.replicas, dtype=self.dtype))(x)

    def graphs_engage(self, device: torch.device) -> bool:
        return super().graphs_engage(device) and self.graphable and ACT_FQ.get() is None


class TFLiteSimRunner(_DeviceRunner):
    """INT8 integer-graph executor of a .tflite flatbuffer on one device
    (default CUDA; raises if there is none) or over a local mesh (`mesh=`,
    module docstring), bit-exact with the JAX package's. One executor is
    built per (batch size, entry form, device) and kept; callers should
    batch uniformly (pad the tail). Under a mesh each shard runs the
    executor of its device at the shard's batch size; an executor holds
    its graph's constants and no state between calls.

    Two entry forms give the same scores, bit for bit: float features
    feed the graph's own entry QUANTIZE; when the graph starts with
    QUANTIZE -> TRANSPOSE, `entry_quant` is that QUANTIZE's (scale,
    zero_point) (else None), and the int8 entry tensor [B, 1, W, bins]
    quantized with it (frontend_input(quant=entry_quant)) skips both ops
    (build_executor(prequantized_input=True)).

    On a CUDA device the kept executor is a CUDA graph of the eager one
    (_GraphedCall), bit-equal. Each graph keeps its own memory pool
    reserved for the runner's life: about 400 MB at 64 flagship rows on an
    H100, where an eager call peaks at about 290 MB. On the CPU, and where
    `build_executor` is called directly (return_all, torch.export), the
    executor stays eager."""

    _GRAPH = (GRAPH, "TFLiteSimRunner executor", "(batch, prequantized, device)")

    def __init__(self, tflite: str | Path | bytes | TFLiteGraph,
                 device: str | torch.device | None = None, requant: str = "exact", mesh=None):
        if requant not in REQUANT_MODES:
            raise ValueError(f"Invalid requant: {requant!r} (expected one of {REQUANT_MODES})")
        super().__init__(mesh, device)
        self.graph = tflite if isinstance(tflite, TFLiteGraph) else TFLiteGraph(tflite)
        self.requant = requant
        self.entry_quant = (entry_quant_params(self.graph)
                            if entry_transpose_perm(self.graph) is not None else None)

    def executor(self, batch_size: int, prequantized_input: bool = False,
                 device: torch.device | None = None):
        """The executor for `batch_size` on `device` (default self.device);
        with prequantized_input it takes the int8 entry tensor
        [B, 1, W, bins] (class docstring). On a CUDA device it is the
        executor's CUDA graph."""
        device = self.device if device is None else device
        return self._kept((batch_size, prequantized_input, device), lambda: build_executor(
            self.graph, batch_size, device=device, requant=self.requant,
            prequantized_input=prequantized_input))

    def forward_block(self, x: torch.Tensor) -> torch.Tensor:
        """The scores of rows on one device of the mesh, by the executor
        of x's entry form: an int8 tensor is the prequantized entry."""
        return self.executor(x.shape[0], x.dtype == torch.int8, x.device)(x)


class _GraphedCall:
    """A device call (an integer executor, a model's eval forward) replayed
    as one CUDA graph for one key (batch size, input form, card).

    The first call runs the eager call on a side stream of the key's card,
    which checks its input and readies cuDNN, cuBLAS and the allocator, and
    returns that answer; then one call is captured into a CUDA graph on the
    same stream, from a static input buffer allocated before the capture.
    Every later call checks x's shape, dtype and device, copies it into
    that buffer, replays the graph and returns a clone of its output, so an
    answer a caller holds (or another row block on the same card) is never
    overwritten by the next replay. While a profiler records, the copy,
    replay and clone run in one span `span_name`. If the capture raises,
    the key keeps the eager call from then on, which is said once on stderr
    under `label`, with the key described by `key_names`.

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
