"""PyTorch port, float model: every configuration the serving dispatch
accepts against Flax.

The nine executor-fuzz configurations (tests/test_executor_fuzz.py, their
committed variables in tests/goldens/torch_fuzz) carry hybrid (pwl, pcen,
db), raw (4000 and 4100 Hz), librosa, mfcc and log_mel frontends, the
softmax and sigmoid heads, inverted-residual and plain blocks with and
without SE and attention pooling. Their Flax variables go into the port
through models/convert.py. Beyond them: the learnable mel breakpoints
(tri_mel_matrix, learn_mel_scale), the pcen and raw frontend layers with
perturbed parameters and BN statistics, and the logits head.

Tolerance: atol 1e-5 on scores and frontend outputs of unit scale (as
tests/test_torch_model.py; both sides float32, differing in summation
order); on tri_mel_matrix 1e-6 where XLA sums the segment widths in index
order (17 values) and 5e-5 past that (see the test); 1e-5 on the waveform
features.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu.models.frontend_layer import AudioFrontend as JaxAudioFrontend
from birdnet_stm32_tpu.models.frontend_layer import tri_mel_matrix as j_tri_mel_matrix
from birdnet_stm32_tpu.ops.frontend import inputs_for_config as j_inputs_for_config
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import RAW_MAX_SAMPLES, build_dscnn
from birdnet_stm32_tpu_torch.models.frontend_layer import AudioFrontend, tri_mel_matrix
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import N_CONFIGS, load

warm_up()


def _port_model(cfg: ModelConfig, variables, class_activation, learn_mel_scale=False):
    model = build_dscnn(cfg, class_activation=class_activation,
                        learn_mel_scale=learn_mel_scale, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_fuzz_config_scores_match_flax(i):
    """The configuration's JAX variables, carried across by convert.py, give
    the Flax model's scores within 1e-5; the committed golden is the Flax
    model's output too."""
    f = load(i)
    jcfg = JaxModelConfig.from_dict(f.cfg)
    jmodel = j_build_dscnn(jcfg, class_activation=f.class_activation)
    v = jax.tree_util.tree_map(jnp.asarray, f.variables)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(f.features)))
    np.testing.assert_allclose(ref, f.float_f32, atol=1e-6)
    model = _port_model(ModelConfig.from_dict(f.cfg), f.variables, f.class_activation)
    with torch.no_grad():
        got = model(torch.from_numpy(f.features)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_inputs_for_config_matches_jax_on_committed_waves(i):
    """The port's composition maps the committed waveforms to the JAX
    features (committed, and recomputed here)."""
    f = load(i)
    ref = np.asarray(j_inputs_for_config(jnp.asarray(f.waves), JaxModelConfig.from_dict(f.cfg)))
    np.testing.assert_array_equal(ref, f.wave_features)
    got = inputs_for_config(torch.from_numpy(f.waves), ModelConfig.from_dict(f.cfg)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


# tri_mel_matrix sums its M+1 segment widths twice (a total and a running
# sum). XLA's CPU reduction adds up to 17 values in index order, as the port
# does, and the matrices agree within 1e-6 there; with more values XLA
# vectorizes the sums in an order of its own, a breakpoint (~50 mel) can
# move by an ulp, and the triangles by up to 2.2e-5 (measured at 33 and 65
# values), held at 5e-5.
@pytest.mark.parametrize("sr,n_fft,mels,seed,tol", [
    (4000, 128, 16, 0, 1e-6), (4000, 128, 16, 1, 1e-6), (8000, 256, 32, 2, 5e-5),
    (22050, 512, 64, 3, 5e-5)])
def test_tri_mel_matrix_matches_jax(sr, n_fft, mels, seed, tol):
    logits = np.random.default_rng(seed).normal(0, 1.0, mels + 1).astype(np.float32)
    for seg in (np.zeros_like(logits), logits):
        ref = np.asarray(j_tri_mel_matrix(jnp.asarray(seg), sr, n_fft, mels))
        got = tri_mel_matrix(torch.from_numpy(seg), sr, n_fft, mels).numpy()
        assert got.shape == ref.shape == (n_fft // 2 + 1, mels)
        np.testing.assert_allclose(got, ref, atol=tol)


def _perturbed(fmod, x, seed):
    """Flax frontend variables with every vector moved off its init value
    (BN scale / var positive; the mel mixer scaled, staying non-negative
    as the reference's NonNeg constraint keeps it)."""
    rng = np.random.default_rng(seed)
    v = jax.device_get(fmod.init(jax.random.key(seed), jnp.asarray(x)))

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = str(path[-1].key)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            return a
        if name == "mel_mixer":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a + rng.normal(0.0, 0.05, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, v)


def _frontend_pair(mode, x, seed, **kw):
    fmod = JaxAudioFrontend(mode=mode, **kw)
    v = _perturbed(fmod, x, seed)
    ref = np.asarray(fmod.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x)))
    tmod = AudioFrontend(mode, **kw).eval()
    tmod.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("learn", [False, True])
@pytest.mark.parametrize("mag", ["pcen", "pwl", "db"])
def test_hybrid_frontend_pcen_and_learned_mel_match_flax(mag, learn):
    """In-graph pcen (pcen_agc, pcen_k1, pcen_shift_w/b, pcen_k2mk1) and the
    learnable mel breakpoints (mel_seg_logits through tri_mel_matrix)."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 65, 40, 1)).astype(np.float32)
    got, ref = _frontend_pair("hybrid", x, 4, mel_bins=16, spec_width=32, sample_rate=4000,
                              fft_length=128, mag_scale=mag, learn_mel_scale=learn)
    assert got.shape == ref.shape == (2, 16, 32, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("sr,mag", [(4000, "none"), (4100, "pwl"), (4100, "pcen")])
def test_raw_frontend_matches_flax(sr, mag):
    """Symmetric pad (pad_l = total // 2), VALID conv1d filterbank k=16,
    stride ceil(T/W), BN on running statistics (eps 1e-3), ReLU6, scaling."""
    T = sr
    x = np.random.default_rng(5).uniform(-1, 1, (3, T, 1)).astype(np.float32)
    got, ref = _frontend_pair("raw", x, 6, mel_bins=16, spec_width=32, sample_rate=sr,
                              chunk_duration=1.0, mag_scale=mag)
    assert got.shape == ref.shape == (3, 16, 32, 1)
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("activation,learn", [("none", False), ("sigmoid", True),
                                              ("softmax", True)])
def test_heads_and_learned_mel_dscnn_match_flax(activation, learn):
    """The logits / sigmoid / softmax heads, with and without the learnable
    mel breakpoints, on a hybrid config with perturbed segment logits."""
    jcfg = JaxModelConfig(sample_rate=4000, num_mels=16, spec_width=32, fft_length=128,
                          chunk_duration=1.0, embeddings_size=32, num_classes=4,
                          class_names=list("abcd"), alpha=0.25, audio_frontend="hybrid",
                          mag_scale="pwl", use_se=False, use_inverted_residual=False)
    jmodel = j_build_dscnn(jcfg, class_activation=activation, learn_mel_scale=learn)
    v = jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(9)))
    if learn:
        seg = v["params"]["audio_frontend"]["mel_seg_logits"]
        v["params"]["audio_frontend"]["mel_seg_logits"] = np.random.default_rng(9).normal(
            0, 0.5, seg.shape).astype(np.float32)
    x = np.random.default_rng(10).uniform(0, 1, (3, *jcfg.input_shape())).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x)))
    model = _port_model(ModelConfig.from_dict(jcfg.to_dict()), v, activation, learn)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_raw_length_guard_and_head_names():
    cfg = ModelConfig(sample_rate=22050, chunk_duration=3.0, audio_frontend="raw",
                      mag_scale="none", num_classes=4, class_names=list("abcd"))
    assert cfg.chunk_samples >= RAW_MAX_SAMPLES
    with pytest.raises(ValueError, match="raw frontend input length"):
        build_dscnn(cfg, device="cpu")
    small = ModelConfig(sample_rate=4000, chunk_duration=1.0, audio_frontend="raw",
                        mag_scale="none", num_classes=4, class_names=list("abcd"))
    with pytest.raises(ValueError, match="class_activation"):
        build_dscnn(small, class_activation="tanh", device="cpu")
