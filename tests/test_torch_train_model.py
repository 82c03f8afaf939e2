"""PyTorch port, the DS-CNN in train mode against the JAX package's.

The port's model.train() forward on the CPU against Flax
apply(train=True, mutable=["batch_stats"]) from the same variables on the
same inputs, dropout off on both sides (tests/torch_train_fixtures.py):
the logits and the new BN running statistics, for the hybrid (plain DS
blocks) and librosa configs and the raw frontend (its conv filterbank's
BN). Train-mode BN divides by the batch's spread, so the backends'
float32 summation-order differences (~1e-6) grow to ~1e-4 on logits of
size ~1.5: logits within 3e-4 absolute, each BN statistic within 5e-5 of
its tensor's largest value. Keras / Flax update the running variance with
the biased batch variance; torch's BatchNorm would use the unbiased one,
which the batch-of-2 test tells apart.

freeze_bn and freeze_frontend_bn keep BN on its running statistics with no
update (all of them, or the frontend's only), as in Flax. The blocks'
SpatialDropout2D zeroes whole channels and scales the rest by 1 / (1 - p).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import flax_dropout_off, pair, port_dropout_off

warm_up()

CONFIGS = {"hybrid": {}, "librosa": dict(audio_frontend="librosa"),
           "raw": dict(audio_frontend="raw")}


def _inputs(cfg, seed, B=8):
    return np.random.default_rng(seed).random((B, *cfg.input_shape())).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax_train(name: str, freeze_bn: bool = False, freeze_frontend_bn: bool = False, B: int = 8):
    jmodel, v, _, jcfg, _ = pair(**CONFIGS[name])
    x = _inputs(jcfg, 7, B)
    with flax_dropout_off():
        out, upd = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)},
            freeze_bn=freeze_bn, freeze_frontend_bn=freeze_frontend_bn))(v, x)
    return np.asarray(out), flax_to_state_dict(jax.device_get(upd))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_forward_and_bn_stats_match_flax(name):
    jout, jstats = _flax_train(name)
    _, _, model, _, cfg = pair(**CONFIGS[name])
    model = port_dropout_off(model).train()
    out = model(torch.from_numpy(_inputs(cfg, 7))).detach().numpy()
    np.testing.assert_allclose(out, jout, rtol=0, atol=3e-4)
    got = model.state_dict()
    assert jstats and all(k in got for k in jstats)
    for k, ref in jstats.items():
        assert (got[k] - ref).abs().max() <= 5e-5 * ref.abs().max(), k
    if name == "raw":
        assert "audio_frontend.raw_fb_bn.running_var" in jstats


def test_running_variance_is_biased():
    """Batch of 2: the unbiased variance would be twice the biased one."""
    jout, jstats = _flax_train("librosa", B=2)
    _, _, model, _, cfg = pair(**CONFIGS["librosa"])
    port_dropout_off(model).train()(torch.from_numpy(_inputs(cfg, 7, 2)))
    got = model.state_dict()["stage4_ds2_pw_bn.running_var"]
    ref = jstats["stage4_ds2_pw_bn.running_var"]
    assert (got - ref).abs().max() <= 5e-5 * ref.abs().max()


@pytest.mark.parametrize("freeze", ["freeze_bn", "freeze_frontend_bn"])
def test_frozen_bn_matches_flax_and_keeps_stats(freeze):
    flags = {"freeze_bn": freeze == "freeze_bn", "freeze_frontend_bn": True}
    jout, jstats = _flax_train("raw", **flags)
    _, v, model, _, cfg = pair(**CONFIGS["raw"])
    before = {k: t.clone() for k, t in model.state_dict().items()}
    model = port_dropout_off(model).train(**flags)
    out = model(torch.from_numpy(_inputs(cfg, 7))).detach().numpy()
    np.testing.assert_allclose(out, jout, rtol=0, atol=3e-4)
    after = model.state_dict()
    for k in after:
        if "running" in k:
            frozen = flags["freeze_bn"] or k.startswith("audio_frontend.")
            assert torch.equal(after[k], before[k]) == frozen, k
            if frozen:
                assert torch.equal(jstats[k], before[k]), k
    assert not model.audio_frontend.raw_fb_bn.training and model.stem_bn.training != flags["freeze_bn"]
    assert not model.eval().training and not model.stem_bn.training


def test_spatial_dropout_drops_whole_channels():
    """At p = 0.1 each (sample, channel) map is all zero or x / 0.9; about
    10 % of them are zero; the head's dropout follows cfg.dropout_rate."""
    _, _, model, _, _ = pair(dropout_rate=0.5)
    drop = model.stage3_ds2_drop
    assert isinstance(drop, torch.nn.Dropout2d) and drop.p == pytest.approx(0.1)
    assert model.dropout.p == pytest.approx(0.5)
    torch.manual_seed(0)
    x = torch.rand(64, 32, 4, 4) + 0.5
    y = drop.train()(x)
    zero = (y == 0).all(dim=(2, 3))
    kept = ~zero
    assert torch.allclose(y[kept], (x / 0.9)[kept], rtol=1e-6, atol=0)
    assert 0.07 <= zero.float().mean() <= 0.13
    assert torch.equal(drop.eval()(x), x)
