"""PyTorch port, mixed-precision training (parallel/steps.py
compute_dtype=torch.bfloat16, the bf16-feature batcher) against the JAX
package's make_train_step(compute_dtype=jnp.bfloat16).

One step from the same variables on the same features, sgd (lr 1e-2) and
adam (lr 1e-3), dropout off on both sides.

- learn_mel_scale config, whose network computes in float32 from the mixer
  product on (JAX's dtypes; tests/test_torch_bf16.py): the loss within 1e-5
  relative (read: equal) and the whole update within 5e-2 relative in L2
  (read: 4.1e-3 sgd, 7.9e-6 adam); the BN running statistics within 1e-4
  relative in L2 (read: 5.6e-6).
- hybrid config, in bf16 throughout, from a trained state (WARM_STEPS
  float32 adam steps on tone batches; at initialisation the tiny model is
  chaotic in bf16: JAX's own bf16 update is ~100 % from its float32 one,
  and no two bf16 implementations can be told apart from a zero update).
  There JAX's own bf16-vs-float32 distance N is ~0.4 of the float32 update
  (two roundings of 30 bf16 layers; read 0.42), but only 0.6-1.6 % on the
  head. Held: the loss within 1e-3 relative of JAX's bf16 loss (read
  5.8e-5); the port's bf16 update between N/2 and 2N from JAX's float32
  update (read 0.87N), so it carries bf16 noise of JAX's size; and on the
  head (emb_bn, pred), each tensor within HEAD_RTOL = 5e-2 of JAX's float32
  update (read 1.6e-2 at most). A zero update (2.4N; 1.0 on the head) and
  the port's float32 step (1.0e-3 N) each fail these gates (asserted).
- Both: the masters, the optimizer state and the BN statistics stay
  float32; the gradients reach the masters through the casts.
- The batcher with stft_precision 'high' and bf16 features, augmentation
  off: the port casts the kernel's float32 output once, so it is within one
  bf16 ulp of JAX's float32 features cast to bf16 (>= 99.9 % equal);
  JAX's bf16 batcher runs the bf16-I/O STFT, which rounds the frames and
  the bases first: within 2^-7 of it (two bf16 ulps just below 1; read: 13
  of 16,640 entries beyond one ulp, 20 % equal). With augmentation on it
  casts once, after mixup: equal to the float32 batcher's output cast to
  bf16, from the same generator.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.data.pipeline import make_train_batcher as j_make_train_batcher
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu.parallel.steps import TrainState as JTrainState
from birdnet_stm32_tpu.parallel.steps import make_train_step as j_make_train_step
from birdnet_stm32_tpu.training.losses import make_loss_fn as j_make_loss_fn
from birdnet_stm32_tpu.training.optimizer import build_optimizer as j_build_optimizer
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_train_step
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer
from birdnet_stm32_tpu_torch.utils.prng import generator
from tests.test_torch_bf16 import FEATURE_ATOL, _bf16_ulps
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_trainer import _batches
from tests.torch_train_fixtures import TINY, flax_dropout_off, port_dropout_off
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

warm_up()

BF16 = torch.bfloat16
LR = {"sgd": 1e-2, "adam": 1e-3}
WARM_STEPS = 60
HEAD = ("emb_bn.weight", "emb_bn.bias", "pred.weight", "pred.bias")
HEAD_RTOL = 5e-2


@functools.lru_cache(maxsize=None)
def _models(learn_mel_scale: bool):
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    jmodel = j_build_dscnn(jcfg, class_activation="none", learn_mel_scale=learn_mel_scale)
    v = jax.device_get(j_init_model(jmodel, jcfg, jax.random.key(0)))
    if learn_mel_scale:
        v["params"]["audio_frontend"]["mel_seg_logits"] = (
            np.random.default_rng(0).normal(0, 1.0, 17).astype(np.float32))
    model = build_dscnn(cfg, class_activation="none", learn_mel_scale=learn_mel_scale,
                        device="cpu")
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return jmodel, v, port_dropout_off(model), cfg


def _features(cfg, B):
    rng = np.random.default_rng(0)
    x = rng.random((B, *cfg.input_shape())).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]


@functools.lru_cache(maxsize=None)
def _warm_hybrid():
    """(JAX variables after WARM_STEPS float32 adam steps on eight tone
    batches, a ninth batch's features), from the port's float32 batcher."""
    jmodel, v, _, cfg = _models(False)
    batcher = make_train_batcher(cfg, spec_augment=False, mixup_probability=0.0)
    feats = [tuple(t.numpy() for t in batcher(generator(0), *map(torch.from_numpy, b)))
             for b in _batches(cfg, 9, B=32)]
    jtx = j_build_optimizer("adam", 1e-2, gradient_clip_norm=1.0)
    state = JTrainState.create(v, jtx)
    step = j_make_train_step(jmodel, jtx, j_make_loss_fn(), donate=False)
    with flax_dropout_off():
        for i in range(WARM_STEPS):
            state, _ = step(state, *feats[i % 8], jax.random.key(0))
    return jax.device_get(state.variables()), feats[8]


@functools.lru_cache(maxsize=None)
def _steps(learn_mel_scale: bool, optimizer: str):
    """{dtype: (JAX loss, JAX update, port loss, port update, port after,
    port opt_state)} for the float32 and the bf16 step."""
    jmodel, v, model, cfg = _models(learn_mel_scale)
    if learn_mel_scale:
        x, y = _features(cfg, 8)
        dtypes = ((jnp.bfloat16, BF16),)
    else:
        # The float32 step too: the bf16 noise is measured against it.
        v, (x, y) = _warm_hybrid()
        dtypes = ((None, None), (jnp.bfloat16, BF16))
    before = flax_to_state_dict(v)
    out = {}
    for jdt, dt in dtypes:
        jtx = j_build_optimizer(optimizer, LR[optimizer], gradient_clip_norm=1.0)
        with flax_dropout_off():
            js, jm = j_make_train_step(jmodel, jtx, j_make_loss_fn(), donate=False,
                                       compute_dtype=jdt)(
                JTrainState.create(v, jtx), x, y, jax.random.key(0))
        jafter = flax_to_state_dict(jax.device_get(js.variables()))
        m = copy.deepcopy(model)
        m.load_state_dict(before)
        tx = build_optimizer(optimizer, LR[optimizer], gradient_clip_norm=1.0)
        state, pm = make_train_step(m, tx, make_loss_fn(), compute_dtype=dt)(
            TrainState.create(m, tx), torch.from_numpy(x), torch.from_numpy(y))
        after = m.state_dict()
        keys = [k for k in before if "num_batches" not in k]
        out[dt] = (float(jm["loss"]), {k: jafter[k] - before[k] for k in keys},
                   float(pm["loss"]), {k: after[k] - before[k] for k in keys}, after, state)
    return out


def _l2(tree, keys):
    return torch.cat([tree[k].flatten() for k in keys])


def _param_keys(tree):
    return [k for k in tree if "running" not in k]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_learn_mel_scale_mixed_step_matches_jax(optimizer):
    jl, ju, pl, pu, _, _ = _steps(True, optimizer)[BF16]
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    keys = _param_keys(ju)
    d = _l2(pu, keys) - _l2(ju, keys)
    assert float(d.norm() / _l2(ju, keys).norm()) <= 5e-2
    stats = [k for k in ju if "running" in k]
    assert float((_l2(pu, stats) - _l2(ju, stats)).norm() / _l2(ju, stats).norm()) <= 1e-4


def _hybrid_update_gates(ju16, ju32):
    """update -> bool: the gates of the hybrid bf16 update (module
    docstring), set from JAX's bf16 (ju16) and float32 (ju32) updates."""
    keys = _param_keys(ju32)
    ref = _l2(ju32, keys)
    noise = float((_l2(ju16, keys) - ref).norm())

    def passes(u):
        d = float((_l2(u, keys) - ref).norm())
        head = max(float((u[k] - ju32[k]).norm() / ju32[k].norm()) for k in HEAD)
        return 0.5 * noise <= d <= 2.0 * noise and head <= HEAD_RTOL

    return passes


def test_hybrid_mixed_step_matches_jax_within_bf16_noise():
    steps = _steps(False, "sgd")
    jl, ju, pl, pu, _, _ = steps[BF16]
    ju32, pu32 = steps[None][1], steps[None][3]
    assert abs(pl - jl) <= 1e-3 * abs(jl)
    gates = _hybrid_update_gates(ju, ju32)
    assert gates(pu)
    # The gates tell a bf16 step from a float32 step and from no update.
    assert not gates(pu32)
    assert not gates({k: torch.zeros_like(t) for k, t in pu.items()})


@pytest.mark.parametrize("learn_mel_scale,optimizer", [(False, "sgd"), (True, "adam")])
def test_masters_and_statistics_stay_float32(learn_mel_scale, optimizer):
    _, _, _, pu, after, state = _steps(learn_mel_scale, optimizer)[BF16]
    assert {t.dtype for t in after.values() if t.is_floating_point()} == {torch.float32}
    moments = [t for v in state.opt_state.values() if isinstance(v, dict) for t in v.values()]
    assert moments and {t.dtype for t in moments} == {torch.float32}
    # Every trainable tensor moved: the gradients reached the masters.
    assert all(pu[k].abs().max() > 0 for k in _param_keys(pu))


def test_mixed_step_runs_the_forward_in_bf16():
    """A dtype spy: the convolutions see bf16 inputs and weights."""
    _, _, model, cfg = _models(False)
    m = copy.deepcopy(model)
    seen = set()
    hooks = [mod.register_forward_pre_hook(lambda mod, args: seen.add(
        (args[0].dtype, mod.weight.dtype))) for mod in m.modules()
        if isinstance(mod, torch.nn.Conv2d)]
    x, y = _features(cfg, 4)
    tx = build_optimizer("adam", 1e-3)
    make_train_step(m, tx, make_loss_fn(), compute_dtype=BF16)(
        TrainState.create(m, tx), torch.from_numpy(x), torch.from_numpy(y))
    for h in hooks:
        h.remove()
    # Conv2dSame reads self.weight inside functional_call: the bf16 copy.
    assert seen == {(BF16, BF16)}


def test_bf16_batcher_matches_jax():
    cfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    wave, labels = _batches(cfg, 1, B=8)[0]

    def jax_batch(**kw):
        x, y = j_make_train_batcher(jcfg, spec_augment=False, mixup_probability=0.0, **kw)(
            jax.random.key(0), jnp.asarray(wave), jnp.asarray(labels))
        return np.asarray(x.astype(jnp.float32)), np.asarray(y)

    batcher = make_train_batcher(cfg, spec_augment=False, mixup_probability=0.0,
                                 stft_precision="high", feature_dtype=BF16)
    x, y = batcher(generator(0), torch.from_numpy(wave), torch.from_numpy(labels))
    assert x.dtype == BF16
    got = x.float().numpy()
    # The cast of JAX's float32 features: within one bf16 ulp.
    f32, ref_y = jax_batch()
    cast = torch.from_numpy(f32).to(BF16).float().numpy()
    ulps = _bf16_ulps(cast, got)
    assert ulps.max() <= 1 and (ulps == 0).mean() >= 0.999
    # JAX's own bf16 features (its bf16-I/O STFT): within two bf16 ulps just
    # below 1.
    b16, _ = jax_batch(stft_precision="high", feature_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, b16, rtol=0, atol=2 * FEATURE_ATOL)
    np.testing.assert_array_equal(y.numpy(), ref_y)


def test_bf16_batcher_casts_once_after_mixup():
    cfg = ModelConfig(**TINY)
    wave, labels = map(torch.from_numpy, _batches(cfg, 1, B=8, seed=3)[0])
    kw = dict(mixup_probability=1.0, mixup_alpha=0.4)
    x16, y16 = make_train_batcher(cfg, feature_dtype=BF16, **kw)(generator(5), wave, labels)
    x32, y32 = make_train_batcher(cfg, **kw)(generator(5), wave, labels)
    assert x32.dtype == torch.float32 and not torch.equal(y32, labels)  # rows were mixed
    assert torch.equal(x16, x32.to(BF16)) and torch.equal(y16, y32)


def test_train_mode_bn_in_bf16_rounds_once_as_flax():
    """Train-mode BN on bf16 input and parameters normalises in float32 and
    rounds once, as Flax's BatchNorm does. torch's own bf16 batch_norm
    rounds between its steps: over a third of its outputs differ. Held: <= 1 % of
    the outputs apart, by one bf16 ulp at most (read: 0.09 %, from XLA's
    E[x^2] - E[x]^2 variance against torch's two-pass one), and the running
    statistics float32."""
    from flax import linen as fnn

    from birdnet_stm32_tpu_torch.models.blocks import BatchNorm2d

    rng = np.random.default_rng(4)
    x = (rng.normal(0.3, 0.7, (32, 16, 16, 8))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale, jnp.bfloat16),
                            "bias": jnp.asarray(bias, jnp.bfloat16)},
                 "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}
    ref, _ = fbn.apply(variables, jnp.asarray(x, jnp.bfloat16), mutable=["batch_stats"])
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)

    bn = BatchNorm2d(8, eps=1e-3, momentum=0.01).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(BF16)
    w16, b16 = bn.weight.to(BF16), bn.bias.to(BF16)
    y = torch.func.functional_call(bn, {"weight": w16, "bias": b16}, (xt,))
    assert y.dtype == BF16 and bn.running_var.dtype == torch.float32
    got = y.detach().float().numpy()
    # One bf16 ulp is at most 2^-7 of the value; near 0, float32's x - mean
    # (read: 1.4e-6 at most).
    np.testing.assert_array_less(np.abs(got - ref), 2.0 ** -7 * np.abs(ref) + 1e-5)
    assert (got != ref).mean() <= 1e-2
    # torch's own bf16 kernel: what the port no longer calls.
    own = torch.nn.functional.batch_norm(xt, None, None, w16, b16, True, 0.0, 1e-3)
    assert (own.detach().float().numpy() != ref).mean() > 0.2  # read: 37 %
