"""Write the nine executor-fuzz configurations' fixtures for the PyTorch port.

The port's tests and its card smoke test (chip_smoke.py) run where there is
neither JAX nor TensorFlow, so this script exports each configuration once
and commits what they compare against. The nine are the JAX package's own
fuzz configurations (tests/test_executor_fuzz.py: CONFIGS and the
per-tensor one), with their geometry, seeds and calibration sets:

    JAX_PLATFORMS=cpu python -m tests.make_torch_fuzz_fixtures

It writes tests/goldens/torch_fuzz/<i>.tflite (convert_to_tflite, int8) and
<i>.npz holding:

- cfg_json, class_activation, per_channel: the configuration;
- features: the fuzz test's [6, ...] graph inputs;
- int8_exact, int8_fast: the jitted JAX executor's outputs on them with
  requant 'exact' and 'fast';
- var/<collection>/<path>: the Flax variables as numpy;
- float_f32, float_bf16: the Flax model's scores on the features, float32
  and through FlaxRunner(dtype=jnp.bfloat16);
- waves, wave_features: seeded waveforms [3, chunk_samples] and the JAX
  inputs_for_config features for them (float32, precision 'highest').

tests/torch_fuzz_fixtures.py reads them without JAX. Not collected by
pytest (its name does not start with test_).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# The tier-1 test settings (tests/conftest.py): full float32 matmuls.
jax.config.update("jax_default_matmul_precision", "highest")

from birdnet_stm32_tpu.config import ModelConfig  # noqa: E402
from birdnet_stm32_tpu.conversion.export_tflite import convert_to_tflite  # noqa: E402
from birdnet_stm32_tpu.models.dscnn import build_dscnn, init_model  # noqa: E402
from birdnet_stm32_tpu.models.runners import FlaxRunner  # noqa: E402
from birdnet_stm32_tpu.ops.frontend import inputs_for_config  # noqa: E402
from birdnet_stm32_tpu.quant.tflite_import import TFLiteGraph, build_executor  # noqa: E402
from tests.test_executor_fuzz import CONFIGS  # noqa: E402

OUT = Path(__file__).resolve().parent / "goldens" / "torch_fuzz"
GEOMETRY = dict(num_mels=16, spec_width=32, fft_length=128, chunk_duration=1.0,
                embeddings_size=32, num_classes=4, class_names=list("abcd"), alpha=0.25)
# The per-tensor configuration (test_executor_fuzz.py::
# test_executor_matches_interpreter_per_tensor): seed 42, per_channel=False.
PER_TENSOR = dict(audio_frontend="hybrid", mag_scale="pwl", use_inverted_residual=True,
                  use_se=True, class_activation="softmax")
N_FEATURES, N_WAVES = 6, 3


def specs():
    """(index, spec, model key, rng seed, per_channel) of the nine."""
    for i, spec in enumerate(CONFIGS):
        yield i, spec, 100 + i, i, True
    yield len(CONFIGS), PER_TENSOR, 42, 42, False


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(("var",) + prefix + (k,)), np.asarray(v, np.float32)


def waves_for(cfg: ModelConfig, seed: int) -> np.ndarray:
    """Seeded chirps in noise, [N_WAVES, chunk_samples] float32."""
    rng = np.random.default_rng(1000 + seed)
    t = np.arange(cfg.chunk_samples) / cfg.sample_rate
    f0 = rng.uniform(200.0, 0.4 * cfg.sample_rate, (N_WAVES, 1))
    chirp = 0.5 * np.sin(2 * np.pi * f0 * t * (1.0 + 0.3 * t))
    return (chirp + rng.normal(0, 0.05, (N_WAVES, t.size))).astype(np.float32)


def make(i: int, spec: dict, key: int, seed: int, per_channel: bool) -> dict:
    spec = dict(spec)
    activation = spec.pop("class_activation")
    sample_rate = spec.pop("_sample_rate", 4000)
    cfg = ModelConfig(sample_rate=sample_rate, **GEOMETRY, **spec)
    model = build_dscnn(cfg, class_activation=activation)
    v = init_model(model, cfg, jax.random.key(key))

    rng = np.random.default_rng(seed)
    lo, hi = (-1, 1) if cfg.audio_frontend == "raw" else (0, 1)
    calib = rng.uniform(lo, hi, (12, *cfg.input_shape())).astype(np.float32)
    tfl = convert_to_tflite(v, cfg, calib, quantize="int8", class_activation=activation,
                            per_channel=per_channel)
    x = rng.uniform(lo, hi, (N_FEATURES, *cfg.input_shape())).astype(np.float32)

    graph = TFLiteGraph(tfl)
    out = {"cfg_json": np.asarray(json.dumps(cfg.to_dict())),
           "class_activation": np.asarray(activation),
           "per_channel": np.asarray(per_channel), "features": x}
    for requant in ("exact", "fast"):
        fwd = jax.jit(build_executor(graph, batch_size=N_FEATURES, requant=requant))
        out[f"int8_{requant}"] = np.asarray(fwd(jnp.asarray(x)))
    out.update(_flat(jax.device_get(v)))
    out["float_f32"] = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    out["float_bf16"] = FlaxRunner(model, v, dtype=jnp.bfloat16).predict(x)
    waves = waves_for(cfg, i)
    out["waves"] = waves
    out["wave_features"] = np.asarray(inputs_for_config(jnp.asarray(waves), cfg))
    (OUT / f"{i}.tflite").write_bytes(tfl)
    np.savez_compressed(OUT / f"{i}.npz", **out)
    return out


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for i, spec, key, seed, per_channel in specs():
        t1 = time.perf_counter()
        make(i, spec, key, seed, per_channel)
        print(f"config {i}: {spec} in {time.perf_counter() - t1:.1f} s", flush=True)
    size = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {OUT} ({size} bytes) in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
