"""Shared inputs of the port's training tests (tests/test_torch_train_*.py,
test_torch_trainer.py, test_torch_cli_train.py): the JAX trainer tests'
tiny config, a Flax model and the port's DSCNN with the same weights, the
Flax dropout switch, and a seeded WAV folder at the model rate.

Flax's train mode always applies the blocks' SpatialDropout (rate 0.1,
fixed) and the head's dropout; the two packages' dropout draws cannot
match, so parity tests run JAX under `flax_dropout_off()` (every
nn.Dropout returns its input) and the port with `port_dropout_off(model)`.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu_torch.audio.io import save_wav
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

# tests/test_trainer.py::tiny_cfg, with the flagship's plain DS blocks and
# no SE, three classes and the head's dropout off.
TINY = dict(sample_rate=4000, num_mels=16, spec_width=32, fft_length=128,
            chunk_duration=1.0, embeddings_size=32, num_classes=3,
            class_names=["a", "b", "c"], audio_frontend="hybrid", mag_scale="pwl",
            alpha=0.25, use_se=False, use_inverted_residual=False, dropout_rate=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread for a module's tests (autouse where imported).
    The tiny models' steps are thousands of small ops; under tier-1's six
    workers on the host's cores, torch's intra-op threads only wait on each
    other. The previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dropout_identity(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@contextlib.contextmanager
def flax_dropout_off():
    """Every Flax nn.Dropout traced inside returns its input."""
    with fnn.intercept_methods(_dropout_identity):
        yield


def port_dropout_off(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return model


@functools.lru_cache(maxsize=None)
def _flax(seed: int, items: tuple):
    jcfg = JaxModelConfig(**dict(items))
    jmodel = j_build_dscnn(jcfg, class_activation="none")
    return jmodel, jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(seed))), jcfg


def pair(seed: int = 0, **overrides):
    """(JAX model, its variables, a fresh port model on the CPU with the
    same weights, JAX cfg, port cfg), both heads 'none' (logits). The Flax
    side is made once per (seed, overrides)."""
    kw = dict(TINY, **overrides)
    items = tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(kw.items()))
    jmodel, variables, jcfg = _flax(seed, items)
    cfg = ModelConfig(**kw)
    model = build_dscnn(cfg, class_activation="none", device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, model, jcfg, cfg


def write_wav_folder(root, sample_rate: int = 4000, classes=("a", "b", "c"),
                     files_per_class: int = 4, seed: int = 0):
    """Mono PCM16 WAVs at `sample_rate`: a tone per class with noise, of
    1.5-3.5 s, plus a noise folder; returns root."""
    rng = np.random.default_rng(seed)
    for ci, cls in enumerate([*classes, "noise"]):
        for i in range(files_per_class):
            t = np.arange(int(sample_rate * rng.uniform(1.5, 3.5))) / sample_rate
            x = rng.normal(0, 0.3 if cls == "noise" else 0.05, t.size)
            if cls != "noise":
                x = x + 0.5 * np.sin(2 * np.pi * (250 + 350 * ci + 20 * i) * t * (1 + 0.1 * t))
            save_wav(x.astype(np.float32), root / cls / f"{cls}_{i}.wav", sample_rate)
    return root


def write_run_dir(run_dir, seed: int = 0, **overrides):
    """A run directory of the port's format (best/state_dict.pt, the config
    and labels sidecars, train_state.json marking a multilabel run, so
    load_model_runner gives a sigmoid head) holding the Flax weights of
    pair(seed, **overrides). Returns (sigmoid-head JAX model, its
    variables, JAX cfg, port cfg)."""
    from birdnet_stm32_tpu_torch.training.checkpoint import save_checkpoint, save_train_state

    _, variables, model, jcfg, cfg = pair(seed, **overrides)
    save_checkpoint(run_dir, model.state_dict(), cfg)
    save_train_state(run_dir, 1, multilabel=True)
    return j_build_dscnn(jcfg, class_activation="sigmoid"), variables, jcfg, cfg
