"""The fuzz configurations' repaired gates fail on a constant output and on
a class-shuffled one (tests/torch_fuzz_fixtures.py::bad_outputs).

The nine committed configurations (tests/goldens/torch_fuzz) are
random-init models with near-uniform scores, so their old score gates
passed both. Each repaired gate is shown here to pass the real output and
to fail the two bad ones, on each configuration:
- the float32 logit gate (logits_match, tests/test_torch_float_configs.py
  and the card test), against JAX's float32 logits;
- the bf16 logit gate (bf16_logits_match, tests/test_torch_bf16.py and the
  card test), against JAX's bf16 logits;
- the executor-tensor gate (executor_tensors_match, the card test: every
  tensor the CUDA executor computes against the CPU executor's), with the
  graph's int8 logits replaced.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.runners import FlaxRunner
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.models.runners import TorchRunner
from birdnet_stm32_tpu_torch.quant.tflite_import import TFLiteGraph, build_executor
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import (
    N_CONFIGS,
    bad_outputs,
    bf16_logits_match,
    executor_tensors_match,
    load,
    logits_match,
    logits_tensor,
)
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401

warm_up()

VARIANTS = ("constant", "shuffled")


@functools.lru_cache(maxsize=None)
def _logits(i: int, bf16: bool):
    """(JAX logits, the port's logits) on the committed features."""
    f = load(i)
    jcfg, cfg = JaxModelConfig.from_dict(f.cfg), ModelConfig.from_dict(f.cfg)
    dtype = jnp.bfloat16 if bf16 else None
    ref = FlaxRunner(j_build_dscnn(jcfg, class_activation="none"),
                     jax.tree_util.tree_map(jnp.asarray, f.variables), jcfg,
                     dtype=dtype).predict(f.features)
    model = build_dscnn(cfg, class_activation="none", device="cpu")
    model.load_state_dict(flax_to_state_dict(f.variables), strict=True)
    got = TorchRunner(model, cfg, device="cpu",
                      dtype=torch.bfloat16 if bf16 else None).predict(f.features)
    return np.asarray(ref), got


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_float32_logit_gate_bites(i, variant):
    ref, got = _logits(i, False)
    assert logits_match(got, ref)
    assert not logits_match(bad_outputs(ref)[variant], ref)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_bf16_logit_gate_bites(i, variant):
    ref, got = _logits(i, True)
    assert bf16_logits_match(got, ref)
    assert not bf16_logits_match(bad_outputs(ref)[variant], ref)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_executor_tensor_gate_bites(i, variant):
    f = load(i)
    graph = TFLiteGraph(f.tflite)
    ref = build_executor(graph, len(f.features), device="cpu", return_all=True)(
        torch.from_numpy(f.features))
    assert executor_tensors_match(dict(ref), ref, graph) == []
    idx = logits_tensor(graph)
    codes = ref[idx].numpy().astype(np.float64)
    assert np.ptp(codes, axis=1).min() > 0  # int8 logits that vary
    bad = dict(ref)
    bad[idx] = torch.from_numpy(np.round(bad_outputs(codes)[variant]).astype(np.int8))
    assert executor_tensors_match(bad, ref, graph)
