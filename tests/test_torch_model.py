"""PyTorch port, model: blocks, frontend layer and DSCNN against Flax.

Flax variables come from the JAX package's own init, with BN statistics,
BN affine terms, biases, mel mixer and pwl vectors perturbed from a numpy
seed so that every converted tensor matters; models/convert.py carries them
into the port. Tolerance: atol 1e-5 on softmax scores and on block outputs
of unit scale — both sides run float32 (Flax at HIGHEST matmul precision,
set in tests/conftest.py) and differ only in summation order.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp
from flax import linen as nn

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models import blocks as jblocks
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu.models.frontend_layer import AudioFrontend as JaxAudioFrontend
from birdnet_stm32_tpu_torch.models import blocks
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import DSCNN
from birdnet_stm32_tpu_torch.models.frontend_layer import AudioFrontend
from tests.test_torch_cpu_warmup import warm_up

warm_up()

# The small config of tests/test_pallas.py's serving test, with the
# flagship's block choice (plain DS blocks, no SE); ModelConfig's own
# defaults (inverted residual + SE) and the remaining options are variants.
SMALL = dict(sample_rate=8000, num_mels=32, spec_width=32, fft_length=256,
             chunk_duration=1.0, embeddings_size=32, num_classes=4,
             class_names=list("abcd"), alpha=0.25, audio_frontend="hybrid",
             mag_scale="pwl", use_se=False, use_inverted_residual=False)
VARIANTS = {
    "flagship_blocks": {},
    "inverted_residual_se": dict(use_se=True, use_inverted_residual=True),
    "ds_se_attention_librosa": dict(use_se=True, use_attention_pooling=True,
                                    audio_frontend="librosa", mag_scale="none"),
    "hybrid_db_depth2": dict(mag_scale="db", depth_multiplier=2, embeddings_size=64),
    # The precomputed-frontend DS-CNN at the served inputs [B, 64, 256, 1]
    # (librosa, log_mel) and [B, 20, 256, 1] (mfcc), at narrow width.
    "librosa_64x256": dict(audio_frontend="librosa", num_mels=64, spec_width=256),
    "mfcc_20x256": dict(audio_frontend="mfcc", num_mels=64, spec_width=256, n_mfcc=20),
}


def _perturb(variables, seed=0):
    """Numpy copy of a Flax variable tree with every non-kernel leaf moved
    off its init value (BN scale/var positive, mixer non-negative)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = str(path[-1].key)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "mel_mixer":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name.startswith("pwl_"):
            return a + rng.normal(0.0, 0.02, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class _FlaxBlock(nn.Module):
    """Runs one JAX block function inside a compact parent, as DSCNN does."""

    kind: str
    features: int
    strides: tuple

    @nn.compact
    def __call__(self, x):
        if self.kind == "conv_bn":
            return jblocks.conv_bn(x, self.features, (3, 3), self.strides, name="t", train=False)
        if self.kind == "ds":
            return jblocks.ds_conv_block(x, self.features, self.strides, name="t")
        return jblocks.inverted_residual_block(x, self.features, strides=self.strides,
                                               use_se=True, name="t")


def _torch_block(kind, cin, cout, strides):
    parent = tnn.Module()
    if kind == "conv_bn":
        blocks.add_conv_bn(parent, "t", cin, cout, (3, 3), strides)
        return parent, lambda x: blocks.conv_bn(parent, x, "t")
    if kind == "ds":
        blocks.add_ds_conv_block(parent, "t", cin, cout, strides)
        return parent, lambda x: blocks.ds_conv_block(parent, x, "t")
    blocks.add_inverted_residual_block(parent, "t", cin, cout, 2, strides, True, 8)
    return parent, lambda x: blocks.inverted_residual_block(parent, x, "t")


def _compare_block(kind, hw, cin, cout, strides, seed):
    x = np.random.default_rng(seed).normal(0, 1, (2, *hw, cin)).astype(np.float32)
    fmod = _FlaxBlock(kind, cout, strides)
    v = _perturb(fmod.init(jax.random.key(seed), jnp.asarray(x)), seed)
    ref = np.asarray(fmod.apply(_to_jax(v), jnp.asarray(x)))
    parent, fwd = _torch_block(kind, cin, cout, strides)
    parent.load_state_dict(flax_to_state_dict(v), strict=True)
    parent.eval()
    with torch.no_grad():
        got = fwd(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("n,s,pads", [(10, 2, (0, 1)), (9, 2, (1, 1)), (10, 1, (1, 1)),
                                      (7, 1, (1, 1)), (1, 2, (1, 1))])
def test_same_pads_follow_flax(n, s, pads):
    """SAME pads asymmetrically at stride 2 on an even size: (0, 1)."""
    assert blocks.same_pads(n, 3, s) == pads


@pytest.mark.parametrize("strides", [(1, 2), (2, 2)])
@pytest.mark.parametrize("hw", [(9, 10), (8, 7), (6, 12)])
def test_conv_bn_same_padding_matches_flax(strides, hw):
    """conv_bn on odd and even sizes at stride (1,2) (the stem) and (2,2)
    matches nn.Conv(padding='SAME') + BatchNorm (eps 1e-3) + ReLU6."""
    _compare_block("conv_bn", hw, 3, 8, strides, seed=hw[0] * 10 + strides[0])


@pytest.mark.parametrize("strides,cin,cout", [((1, 1), 8, 8), ((1, 1), 8, 16),
                                              ((2, 2), 8, 16), ((2, 2), 8, 8)])
def test_ds_conv_block_matches_flax(strides, cin, cout):
    """The residual applies only at stride (1,1) with in == out."""
    _compare_block("ds", (9, 8), cin, cout, strides, seed=cin + cout + strides[0])


@pytest.mark.parametrize("strides,cin,cout", [((1, 1), 8, 8), ((2, 2), 8, 16)])
def test_inverted_residual_se_block_matches_flax(strides, cin, cout):
    _compare_block("ir", (8, 9), cin, cout, strides, seed=40 + strides[0])


@pytest.mark.parametrize("mag", ["none", "pwl", "db"])
def test_hybrid_frontend_layer_matches_flax(mag):
    """Transpose, fp32 mel matmul, ReLU, / (max + 1e-6), per-channel pwl."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 129, 40, 1)).astype(np.float32)
    kw = dict(mel_bins=32, spec_width=32, sample_rate=8000, fft_length=256, mag_scale=mag)
    fmod = JaxAudioFrontend(mode="hybrid", **kw)
    v = _perturb(fmod.init(jax.random.key(0), jnp.asarray(x)), 1)
    ref = np.asarray(fmod.apply(_to_jax(v), jnp.asarray(x)))
    tmod = AudioFrontend("hybrid", **kw)
    tmod.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_convert_layouts():
    v = {"params": {"c_conv": {"kernel": np.zeros((3, 1, 4, 8))},
                    "d_dw": {"kernel": np.zeros((3, 3, 1, 16))},
                    "pred": {"kernel": np.zeros((32, 5)), "bias": np.zeros(5)},
                    "c_bn": {"scale": np.ones(8), "bias": np.zeros(8)},
                    "audio_frontend": {"mel_mixer": np.zeros((129, 32)),
                                       "mag": {"pwl_k0": np.zeros(32)}}},
         "batch_stats": {"c_bn": {"mean": np.zeros(8), "var": np.ones(8)}}}
    sd = flax_to_state_dict(v)
    shapes = {k: tuple(t.shape) for k, t in sd.items()}
    assert shapes == {
        "c_conv.weight": (8, 4, 3, 1), "d_dw.weight": (16, 1, 3, 3),
        "pred.weight": (5, 32), "pred.bias": (5,), "c_bn.weight": (8,),
        "c_bn.bias": (8,), "c_bn.num_batches_tracked": (),
        "audio_frontend.mel_mixer": (129, 32), "audio_frontend.mag.pwl_k0": (32,),
        "c_bn.running_mean": (8,), "c_bn.running_var": (8,)}


def _dscnn_pair(variant):
    jcfg = JaxModelConfig(**{**SMALL, **VARIANTS[variant]})
    jmodel = j_build_dscnn(jcfg)
    v = _perturb(j_init_model(jmodel, jcfg, jax.random.key(0)), seed=3)
    tmodel = DSCNN(**{k: getattr(jcfg, k) for k in (
        "num_mels", "spec_width", "sample_rate", "embeddings_size", "num_classes",
        "audio_frontend", "alpha", "depth_multiplier", "mag_scale", "n_mfcc", "use_se",
        "se_reduction", "use_inverted_residual", "expansion_factor",
        "use_attention_pooling")}, fft_length=jcfg.fft_length)
    tmodel.load_state_dict(flax_to_state_dict(v), strict=True)
    return jcfg, jmodel, v, tmodel.eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dscnn_matches_flax(variant):
    """Converted init_model weights give the same scores and embeddings."""
    jcfg, jmodel, v, tmodel = _dscnn_pair(variant)
    x = np.random.default_rng(2).uniform(0, 1, (3, *jcfg.input_shape())).astype(np.float32)
    ref, ref_emb = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                                     return_embeddings=True))(_to_jax(v), x)
    with torch.no_grad():
        got, emb = tmodel(torch.from_numpy(x), return_embeddings=True)
    assert got.shape == (3, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref_emb = np.asarray(ref_emb)
    np.testing.assert_allclose(emb.numpy(), ref_emb,
                               atol=1e-5 * max(1.0, float(np.abs(ref_emb).max())))


def test_emb_layer_skipped_when_channels_match():
    """The flagship's last stage already has embeddings_size channels, so it
    has no 'emb' conv_bn; the small config (64 -> 32) has one."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    flagship = build_dscnn(ModelConfig.load("artifacts/flagship/bundle/model_config.json"),
                           device="cpu")
    assert not hasattr(flagship, "emb_conv")
    assert len([k for k, _ in flagship.blocks if k == "ds"]) == 11
    small = build_dscnn(ModelConfig(**SMALL), device="cpu")
    assert hasattr(small, "emb_conv")
