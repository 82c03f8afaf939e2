"""PyTorch port, INT8 fake-quantization (quant/fake_quant.py) against the
JAX package's.

- fake_quantize, per-channel on each layout (conv, depthwise, dense: the
  port's axis 0 against JAX's axis -1) and per-tensor, and
  fake_quantize_act, bit-equal to the jitted JAX functions on seeded and
  on tie-rich inputs (values on the quantization grid).
- What XLA does to the arithmetic under jit: the division by 255 becomes a
  multiply by float32(1/255); the division by the per-channel scale stays
  a true division; round(.) * scale + w_min is contracted into one fused
  multiply-add (a separately rounded product and sum differ from JAX on
  most entries). The port matches all three.
- The straight-through gradient is the identity.
- The weight selection equals JAX's with the names mapped through
  models/convert.py, and quantize_params equals JAX's jitted one bit for
  bit (op-by-op JAX rounds the product and the sum separately).
- The activation hook fires after every hookable ReLU6, as often as in
  the JAX model, and never in the frontend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.models import blocks as j_blocks
from birdnet_stm32_tpu.quant.fake_quant import fake_quantize as j_fake_quantize
from birdnet_stm32_tpu.quant.fake_quant import fake_quantize_act as j_fake_quantize_act
from birdnet_stm32_tpu.quant.fake_quant import is_quantizable as j_is_quantizable
from birdnet_stm32_tpu.quant.fake_quant import quantize_params as j_quantize_params
from birdnet_stm32_tpu_torch.models import blocks
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.quant.fake_quant import (
    activation_fake_quant,
    fake_quantize,
    fake_quantize_act,
    fake_quantize_ste,
    is_quantizable,
    quantize_params,
)
from tests.torch_train_fixtures import pair
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

# JAX layout -> the port's: conv [kh, kw, I, O] -> [O, I, kh, kw] (depthwise
# [3, 3, 1, C] -> [C, 1, 3, 3]), dense [I, O] -> [O, I].
LAYOUTS = {"conv": ((3, 3, 16, 24), (3, 2, 0, 1)), "depthwise": ((3, 3, 1, 32), (3, 2, 0, 1)),
           "pointwise": ((1, 1, 8, 16), (3, 2, 0, 1)), "dense": ((64, 10), (1, 0))}

_jfq = jax.jit(j_fake_quantize, static_argnames=("num_bits", "per_channel", "channel_axis"))
_jfa = jax.jit(j_fake_quantize_act, static_argnames=("num_bits",))


def _weights(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        # On a 255-step grid between -0.5 and 0.5: (w - min) / scale lands
        # on and half-way between integers.
        return (rng.integers(-255, 256, size=shape) / 510.0).astype(np.float32)
    return (rng.normal(size=shape) * {"normal": 0.3, "wide": 5.0}[kind]).astype(np.float32)


def _port(w, perm):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(perm)))


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("per_channel", [True, False])
def test_fake_quantize_bit_equal(layout, kind, per_channel):
    shape, perm = LAYOUTS[layout]
    w = _weights(shape, kind, seed=len(layout))
    ref = np.asarray(_jfq(w, per_channel=per_channel, channel_axis=-1)).transpose(perm)
    got = fake_quantize(_port(w, perm), per_channel=per_channel)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["signed", "relu6", "ties"])
def test_fake_quantize_act_bit_equal(kind):
    rng = np.random.default_rng(7)
    x = {"signed": rng.normal(0, 2.0, (8, 16, 12, 4)),
         "relu6": np.clip(rng.normal(2, 2.0, (8, 16, 12, 4)), 0, 6),
         "ties": rng.integers(-60, 196, (8, 100)) / 510.0 * 6}[kind].astype(np.float32)
    np.testing.assert_array_equal(fake_quantize_act(torch.from_numpy(x)).numpy(),
                                  np.asarray(_jfa(x)))


def test_xla_contracts_the_multiply_add():
    """JAX's result is the fused multiply-add of round(.) * scale + w_min
    (float64 here, where the product is exact), with the scale made by a
    float32(1/255) multiply: separately rounded arithmetic differs."""
    w = _weights((3, 3, 16, 64), "normal", seed=1)
    ref = np.asarray(_jfq(w))
    lo, hi = w.min((0, 1, 2), keepdims=True), w.max((0, 1, 2), keepdims=True)
    scale = np.maximum((hi - lo) * (np.float32(1) / np.float32(255)), np.float32(1e-10))
    r = np.round((w - lo) / scale)
    fused = (r.astype(np.float64) * scale + lo.astype(np.float64)).astype(np.float32)
    separate = r * scale + lo
    np.testing.assert_array_equal(fused, ref)
    assert (separate != ref).mean() > 0.1


def test_straight_through_gradient_is_identity():
    w = torch.randn(8, 4, 3, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.randn(w.shape, generator=torch.Generator().manual_seed(1))
    wq = fake_quantize_ste(w)
    assert torch.equal(wq.detach(), fake_quantize(w.detach()))
    (wq * g).sum().backward()
    assert torch.equal(w.grad, g)
    x = torch.randn(8, 36, generator=torch.Generator().manual_seed(2), requires_grad=True)
    xq = fake_quantize_act(x)
    (xq * g.reshape(8, 36)).sum().backward()
    assert torch.equal(x.grad, g.reshape(8, 36))


CONFIGS = {"ir_se_attention": dict(use_se=True, use_inverted_residual=True,
                                   use_attention_pooling=True),
           "raw_ds_se": dict(audio_frontend="raw", use_se=True)}


def _port_name(path) -> str:
    keys = [p.key for p in path]
    return ".".join(keys[:-1] + ["weight"])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_selection_and_quantize_params_match_jax(config):
    _, v, model, _, _ = pair(**CONFIGS[config])
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    jax_selected = {_port_name(p) for p, leaf in flat if j_is_quantizable(p, leaf)}
    params = dict(model.named_parameters())
    selected = {k for k, t in params.items() if is_quantizable(k, t)}
    assert selected == jax_selected and selected
    assert not any(k.startswith(("audio_frontend.", "attn_pool_score.")) for k in selected)
    # Jitted, as in the QAT step: op-by-op JAX does not fuse the multiply-add.
    jq = flax_to_state_dict({"params": jax.device_get(jax.jit(
        lambda p: j_quantize_params(p, ste=False))(v["params"]))})
    q = quantize_params(params, ste=False)
    for k, t in q.items():
        np.testing.assert_array_equal(t.detach().numpy(), jq[k].numpy(), err_msg=k)
        if k not in selected:
            assert t is params[k]


def _count_jax_hooks(config) -> int:
    jmodel, v, _, jcfg, _ = pair(**CONFIGS[config])
    calls = []
    token = j_blocks._ACT_FQ.set(lambda y: calls.append(y.shape) or y)
    try:
        jax.eval_shape(lambda v, x: jmodel.apply(v, x, train=False), v,
                       jnp.zeros((2, *jcfg.input_shape()), jnp.float32))
    finally:
        j_blocks._ACT_FQ.reset(token)
    return len(calls)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_activation_hook_fires_as_in_jax(config):
    _, _, model, _, cfg = pair(**CONFIGS[config])
    x = torch.rand(2, *cfg.input_shape(), generator=torch.Generator().manual_seed(0))
    calls = []
    token = blocks.ACT_FQ.set(lambda y: calls.append(tuple(y.shape)) or y)
    try:
        model(x)
        n_model = len(calls)
        model.audio_frontend(x)
    finally:
        blocks.ACT_FQ.reset(token)
    assert n_model == _count_jax_hooks(config) > 0
    assert len(calls) == n_model  # the frontend (raw: its ReLU6) never fires
    # The context manager arms fake_quantize_act and disarms on exit.
    with torch.no_grad():
        plain = model(x)
        with activation_fake_quant():
            armed = model(x)
        assert not torch.equal(plain, armed) and torch.equal(plain, model(x))
    assert blocks.ACT_FQ.get() is None
