"""The port's spans: named intervals of the serving path in torch.profiler's
own trace.

While a torch profiler records on the calling thread, `span(name)` is
`torch.profiler.record_function(name)`: the span lands in the profiler's
trace on the host timeline that CUPTI's kernel, memcpy and memset events
share, and a Chrome export shows it as a `user_annotation` event with its
thread. Otherwise `span` returns one shared no-op context, so an untraced
call pays one check (a fraction of a microsecond) and enters no
record_function. `recording()` is that check, for a loop that hoists it.

This docstring is the one catalogue of the spans. They are opened by
models/serving.py::make_fused_classifier (on every leg, with or without a
mesh), quant/tflite_import.py::build_executor,
models/runners.py::_GraphedCall (the CUDA graphs of TFLiteSimRunner and
TorchRunner) and models/blocks.py::mbconv_block; cli/benchmark.py
--trace_dir records them:

- serve.request: one classify call, holding one serve.ingress, then a
  serve.frontend and a serve.model per row block (one block per mesh
  entry), then one serve.egress;
- serve.ingress: the batch to the device (shard_batch's host-to-device
  copies) and each block's dequantize and resample;
- serve.frontend: each block's frontend_input;
- serve.model: each block's model call: the device runner's
  forward_block (on the INT8 leg the executor of the block's entry form),
  or the interpreter's predict;
- serve.egress: the scores to the host, or their gather;
- tflite.<OP> (for example tflite.CONV_2D): each computed step of the
  eager integer executor. Aliased, skipped and dead ops get none, so a
  call holds `executor.steps` of them; on a card a 1x1 CONV_2D and the
  ADD its kernel computes in its epilogue are one step,
  tflite.CONV_2D+ADD;
- tflite.GRAPH: one replay of the integer executor as a CUDA graph
  (models/runners.py::TFLiteSimRunner on a CUDA device): the input copy,
  the replay and the output clone, so every kernel of the call is
  launched inside it. A block served by the graph holds one tflite.*
  span, a block served eagerly `executor.steps` (the CPU, the graph's
  first call, a key whose capture failed): the count of tflite.* spans
  per block says whether the graph engaged;
- torch.GRAPH: one replay of the float model's eval forward as a CUDA
  graph (models/runners.py::TorchRunner on a CUDA device): the input
  copy, the replay and the output clone, so every kernel of the block's
  forward is launched inside it. A block served eagerly holds none (the
  CPU, the graph's first call, a key whose capture failed, a call under
  the activation fake-quant, a model whose layers open spans of their
  own such as EfficientNet's MBConv blocks);
- mbconv.expand, mbconv.dw, mbconv.project: each MBConv block's 1x1
  expand, depthwise and 1x1 project convolution call (the module call
  alone, its SAME padding included; BN, SiLU and the residual add lie
  outside); mbconv.se: the block's whole squeeze-and-excite (pool, both
  dense layers, their activations and the product). A forward of an
  EfficientNet holds one of each per block (none of mbconv.expand where
  the expansion is 1), `len(model.blocks)` blocks.

A request's spans are those its serve.request contains on its thread: the
export keeps no record_function payload, so there is no separate id.
"""

from __future__ import annotations

import contextlib

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

REQUEST = "serve.request"
INGRESS = "serve.ingress"
FRONTEND = "serve.frontend"
MODEL = "serve.model"
EGRESS = "serve.egress"
OP_PREFIX = "tflite."
GRAPH = OP_PREFIX + "GRAPH"
FUSED_CONV_ADD = OP_PREFIX + "CONV_2D+ADD"
TORCH_GRAPH = "torch.GRAPH"
MBCONV_EXPAND = "mbconv.expand"
MBCONV_DW = "mbconv.dw"
MBCONV_SE = "mbconv.se"
MBCONV_PROJECT = "mbconv.project"

_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """True while a torch profiler records on this thread."""
    return _profiler_enabled()


def span(name: str):
    """A profiler span named `name` while a profiler records, else the
    shared no-op context."""
    return record_function(name) if _profiler_enabled() else _NO_SPAN
