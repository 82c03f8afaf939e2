"""PyTorch port, bf16 leg: the bf16-I/O STFT, bf16 features, the bf16
TorchRunner and the bf16 classifier against the JAX package.

Tolerances:
- stft_magnitude(precision='high', out_dtype=bf16): both sides round the
  frames to bf16 once, take both bf16 limbs of the DFT bases, accumulate in
  float32 in their own order and round once; they may differ by one bf16
  rounding. Held: every entry within one bf16 ulp and >= 99.9 % equal
  (found: max 1 ulp, >= 99.98 % equal on these inputs).
- bf16 features in [0, 1]: within 2^-8 (one bf16 ulp just below 1; found
  max 2^-9).
- scores: per-row cosine >= 0.999, the gate of bench.py's bf16 headline,
  against JAX's FlaxRunner(dtype=bfloat16) and against the port's float32.
  The fuzz configurations' scores are near-uniform, so that gate passes a
  constant or class-shuffled vector too; their logits (class_activation
  'none') are held as well, at per-row cosine >= BF16_LOGIT_MIN_COSINE
  (tests/torch_fuzz_fixtures.py; tests/test_torch_fuzz_gates.py shows it
  fails on both).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.runners import FlaxRunner
from birdnet_stm32_tpu.models.serving import make_embedder as j_make_embedder
from birdnet_stm32_tpu.models.serving import make_fused_classifier as j_make_fused_classifier
from birdnet_stm32_tpu.ops.frontend import inputs_for_config as j_inputs_for_config
from birdnet_stm32_tpu.ops.spectrogram import spectrogram_batch as j_spectrogram_batch
from birdnet_stm32_tpu.ops.stft import stft_magnitude as j_stft_magnitude
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.models.runners import TorchRunner
from birdnet_stm32_tpu_torch.models.serving import (
    _precision_and_dtype,
    make_embedder,
    make_fused_classifier,
)
from birdnet_stm32_tpu_torch.ops.frontend import inputs_for_config
from birdnet_stm32_tpu_torch.ops.spectrogram import spectrogram_batch
from birdnet_stm32_tpu_torch.ops.stft import stft_magnitude
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import N_CONFIGS, bf16_logits_match, load

warm_up()

BF16 = torch.bfloat16
MIN_COSINE = 0.999
FEATURE_ATOL = 2.0**-8


def _row_cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in bf16 steps between two arrays of bf16 values (>= 0)."""
    def bits(x):
        return torch.from_numpy(np.array(x, np.float32)).to(BF16).view(torch.int16).int()
    return (bits(a) - bits(b)).abs().numpy()


def _waves(B=3, T=4000, seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, (B, T)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,n_frames", [(128, 125, 32), (512, 258, 40),
                                                (128, 100, 30), (256, 64, 40)])
def test_stft_bf16_io_matches_jax(n_fft, hop, n_frames):
    """Both branches: the strided-view window-2 product (2*hop >= n_fft) and
    the gathered frames (256 / 64)."""
    y = _waves()
    ref = np.asarray(j_stft_magnitude(jnp.asarray(y), n_fft=n_fft, hop=hop, n_frames=n_frames,
                                      precision="high", out_dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    got = stft_magnitude(torch.from_numpy(y), n_fft, hop, n_frames, precision="high",
                         out_dtype=BF16)
    assert got.dtype == BF16 and got.shape == ref.shape
    ulps = _bf16_ulps(ref, got.float().numpy())
    assert ulps.max() <= 1, ulps.max()
    assert (ulps == 0).mean() >= 0.999


def test_stft_precisions_and_dtypes():
    """'highest' with a bf16 out_dtype computes float32 and casts; a float32
    out_dtype computes the same float32 at every precision."""
    y = torch.from_numpy(_waves())
    f32 = stft_magnitude(y, 128, 125, 32)
    for precision in ("highest", "high", "default"):
        assert torch.equal(stft_magnitude(y, 128, 125, 32, precision=precision), f32)
    assert torch.equal(stft_magnitude(y, 128, 125, 32, out_dtype=BF16), f32.to(BF16))
    with pytest.raises(ValueError, match="precision"):
        stft_magnitude(y, 128, 125, 32, precision="tf32")


@pytest.mark.parametrize("mode,mag", [("linear", "none"), ("mel", "pwl"), ("mel", "db"),
                                      ("mel", "pcen"), ("log_mel", "none"), ("mfcc", "none")])
def test_spectrogram_bf16_matches_jax(mode, mag):
    y = _waves()
    kw = dict(sample_rate=4000, n_fft=128, mel_bins=-1 if mode == "linear" else 16,
              spec_width=32, mag_scale=mag, mode=mode)
    ref = np.asarray(j_spectrogram_batch(jnp.asarray(y), stft_precision="high",
                                         feature_dtype=jnp.bfloat16, **kw).astype(jnp.float32))
    got = spectrogram_batch(torch.from_numpy(y), stft_precision="high", feature_dtype=BF16, **kw)
    assert got.dtype == BF16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, atol=FEATURE_ATOL)


def _port_model(f, class_activation=None):
    cfg = ModelConfig.from_dict(f.cfg)
    model = build_dscnn(cfg, class_activation=class_activation or f.class_activation,
                        device="cpu")
    model.load_state_dict(flax_to_state_dict(f.variables), strict=True)
    return cfg, model


@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_bf16_inputs_for_config_matches_jax(i):
    """bf16 features of every frontend (raw casts) on the committed waves."""
    f = load(i)
    ref = np.asarray(j_inputs_for_config(jnp.asarray(f.waves), JaxModelConfig.from_dict(f.cfg),
                                         stft_precision="high", feature_dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    got = inputs_for_config(torch.from_numpy(f.waves), ModelConfig.from_dict(f.cfg),
                            stft_precision="high", feature_dtype=BF16)
    assert got.dtype == BF16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, atol=FEATURE_ATOL)


@pytest.mark.parametrize("i", range(N_CONFIGS))
def test_bf16_classifier_matches_jax(i):
    """The bf16 leg through make_fused_classifier against the JAX one with
    FlaxRunner(dtype=jnp.bfloat16), and against the port's float32 leg, on
    the committed waveforms; the bf16 runner on the committed features
    against the JAX bf16 golden."""
    f = load(i)
    cfg, model = _port_model(f)
    jcfg = JaxModelConfig.from_dict(f.cfg)
    jrunner = FlaxRunner(j_build_dscnn(jcfg, class_activation=f.class_activation),
                         jax.tree_util.tree_map(jnp.asarray, f.variables), jcfg,
                         dtype=jnp.bfloat16)
    ref = j_make_fused_classifier(jrunner, jcfg)(f.waves)
    r16 = TorchRunner(model, cfg, device="cpu", dtype=BF16)
    got = make_fused_classifier(r16, cfg, device="cpu")(f.waves)
    f32 = make_fused_classifier(TorchRunner(model, cfg, device="cpu"), cfg, device="cpu")(
        f.waves)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert _row_cosines(got, ref).min() >= MIN_COSINE
    assert _row_cosines(got, f32).min() >= MIN_COSINE
    assert _row_cosines(r16.predict(f.features), f.float_bf16).min() >= MIN_COSINE
    # The same three on logits, where a constant or shuffled vector fails.
    _, logit_model = _port_model(f, "none")
    jlogits = FlaxRunner(j_build_dscnn(jcfg, class_activation="none"),
                         jax.tree_util.tree_map(jnp.asarray, f.variables), jcfg,
                         dtype=jnp.bfloat16)
    l16 = TorchRunner(logit_model, cfg, device="cpu", dtype=BF16)
    got = make_fused_classifier(l16, cfg, device="cpu")(f.waves)
    assert bf16_logits_match(got, j_make_fused_classifier(jlogits, jcfg)(f.waves))
    assert bf16_logits_match(got, make_fused_classifier(
        TorchRunner(logit_model, cfg, device="cpu"), cfg, device="cpu")(f.waves))
    assert bf16_logits_match(l16.predict(f.features), np.asarray(jlogits.predict(f.features)))


def test_stft_precision_default_rule():
    """None picks 'high' for a runner with a dtype (bf16 features), else
    'highest' (float32 features); an explicit 'highest' keeps float32
    features and the runner casts them."""
    cfg, model = _port_model(load(0))
    r16 = TorchRunner(model, cfg, device="cpu", dtype=BF16)
    r32 = TorchRunner(model, cfg, device="cpu")
    assert _precision_and_dtype(r16, None) == ("high", BF16)
    assert _precision_and_dtype(r32, None) == ("highest", None)
    assert _precision_and_dtype(r16, "highest") == ("highest", None)
    assert _precision_and_dtype(r16, "default") == ("default", BF16)
    waves = load(0).waves
    a = make_fused_classifier(r16, cfg, device="cpu")(waves)
    b = make_fused_classifier(r16, cfg, device="cpu", stft_precision="highest")(waves)
    # On the CPU the kernels' plain version serves both: the bf16 features
    # are the cast of the same float32 features either way.
    np.testing.assert_array_equal(a, b)


def test_bf16_runner_holds_bf16_and_leaves_the_model():
    cfg, model = _port_model(load(2))  # raw: BN in the frontend too
    r16 = TorchRunner(model, cfg, device="cpu", dtype=BF16)
    tensors = [*r16.model.parameters(), *r16.model.buffers()]
    floating = {t.dtype for t in tensors if t.is_floating_point()}
    assert floating == {BF16}
    assert any(not t.is_floating_point() for t in tensors)  # num_batches_tracked
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    out = r16.forward(torch.from_numpy(load(2).features))
    assert out.dtype == torch.float32


def test_bf16_embedder_matches_jax():
    f = load(0)
    cfg, model = _port_model(f)
    jcfg = JaxModelConfig.from_dict(f.cfg)
    jrunner = FlaxRunner(j_build_dscnn(jcfg, class_activation=f.class_activation),
                         jax.tree_util.tree_map(jnp.asarray, f.variables), jcfg,
                         dtype=jnp.bfloat16)
    ref = j_make_embedder(jrunner, jcfg)(f.waves)
    got = make_embedder(TorchRunner(model, cfg, device="cpu", dtype=BF16), cfg,
                        device="cpu")(f.waves)
    f32 = make_embedder(TorchRunner(model, cfg, device="cpu"), cfg, device="cpu")(f.waves)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert _row_cosines(got, ref).min() >= MIN_COSINE
    assert _row_cosines(got, f32).min() >= MIN_COSINE


def test_bf16_learn_mel_scale_follows_jax_dtypes():
    """The hybrid frontend with learn_mel_scale in bf16, against JAX's bf16
    make_infer_fn (variables cast to bf16), with nonzero segment logits:
    as JAX's jaxpr shows, the segment arithmetic runs in bf16, the mixer
    is float32 and the network computes in float32 from the mixer product
    on, on bf16-rounded parameters. Logits (no head) at cosine >= 0.999
    (the bf16 flagship's gate; a network kept in bf16 reads 0.998 here)
    and the float32 flow from the mixer on."""
    from birdnet_stm32_tpu.parallel.steps import make_infer_fn
    from tests.torch_train_fixtures import TINY

    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    jmodel = j_build_dscnn(jcfg, class_activation="none", learn_mel_scale=True)
    from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model

    v = jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    v["params"]["audio_frontend"]["mel_seg_logits"] = rng.normal(0, 1.0, 17).astype(np.float32)
    x = rng.random((4, *cfg.input_shape())).astype(np.float32)
    v16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), v)
    ref = np.asarray(make_infer_fn(jmodel, v16, dtype=jnp.bfloat16)(jnp.asarray(x)))
    model = build_dscnn(cfg, class_activation="none", learn_mel_scale=True, device="cpu")
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    r16 = TorchRunner(model, cfg, device="cpu", dtype=BF16)
    got = r16.predict(x)
    assert _row_cosines(got, ref).min() >= MIN_COSINE
    fe = r16.model.audio_frontend
    assert fe.mixer().dtype == torch.float32
    feats = fe(torch.from_numpy(x).to(BF16))
    assert feats.dtype == torch.float32
