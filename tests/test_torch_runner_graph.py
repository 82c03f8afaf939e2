"""PyTorch port, INT8 runner: which executor TFLiteSimRunner keeps.

On a CUDA device the runner replays its executor as one CUDA graph per
(batch size, entry form, card) (models/runners.py::_GraphedExecutor; held
on the card by tests/test_torch_cuda.py). On the CPU it keeps
build_executor's eager executor itself: the same function object for a
key across calls, the same scores bit for bit as a fresh build_executor,
and the same computed steps: 57 on the flagship graph's own entry (the
entry the benchmark's INT8 cell serves), 55 on the fused entry of its
entry-transpose fixture, whose QUANTIZE and TRANSPOSE the frontend
kernel's int8 epilogue takes over.
"""

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, _GraphedExecutor
from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, flagship_features

B = 2


def _graph_and_input(fused: bool):
    graph = TFLiteGraph(FLAGSHIP_TFLITE)
    if not fused:
        return graph, torch.from_numpy(flagship_features(B, seed=3))
    codes = np.random.default_rng(3).integers(-128, 128, (B, 1, 256, 257))
    return entry_transpose_fixture(graph), torch.from_numpy(codes.astype(np.int8))


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_runner_keeps_the_eager_executor(fused):
    graph, x = _graph_and_input(fused)
    runner = TFLiteSimRunner(graph, device="cpu")
    fwd = runner.executor(B, prequantized_input=fused)
    assert not isinstance(fwd, _GraphedExecutor)
    assert runner.executor(B, prequantized_input=fused) is fwd
    ref = build_executor(graph, B, device="cpu", prequantized_input=fused)
    assert type(fwd) is type(ref) and fwd.__name__ == ref.__name__
    np.testing.assert_array_equal(fwd(x).numpy(), ref(x).numpy())
    if not fused:
        np.testing.assert_array_equal(runner.predict(x.numpy()), ref(x).numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_runner_executor_steps(fused):
    graph, _ = _graph_and_input(fused)
    fwd = TFLiteSimRunner(graph, device="cpu").executor(B, prequantized_input=fused)
    assert fwd.steps == build_executor(graph, B, device="cpu",
                                       prequantized_input=fused).steps
    assert fwd.steps == (55 if fused else 57)

