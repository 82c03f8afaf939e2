"""PyTorch port, mixup and SpecAugment against the JAX package.

The two packages cannot draw the same random numbers (threefry keys vs a
torch.Generator), so each augmentation is held in two parts:

- apply: JAX's own draws, made here from the key exactly as
  data/augment.py makes them, fed to the port's deterministic part
  (augment.mix, augment.mask_features) must give JAX's apply_mixup /
  apply_spec_augment output: the masks, the labels (union and smoothing)
  and the untouched rows bit for bit; the mixed rows (values in [0, 1))
  within 2.4e-7, two float32 ulps at 1: the gains and the gamma draws are
  bit-equal, but XLA's CPU fusion of the three-term weighted sum rounds
  differently from any sequential or fused-multiply-add order in ~3 % of
  the elements;
- draw: the port's draws from a seeded torch.Generator keep the
  invariants of tests/test_augment.py (the exact count of mixed rows,
  distinct partners, the label union, gains summing to one, smoothing,
  the mask law width ~ U[0, min(max, dim)), start ~ U[0, max(1, dim -
  width))), and the Gamma draws follow their law on 200k draws: mean and
  variance within four standard errors of alpha (the variance's standard
  error from the fourth moment, 3 a^2 + 6 a), and a Kolmogorov-Smirnov
  test against scipy's Gamma(alpha) with p > 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.data.augment import apply_mixup as j_apply_mixup
from birdnet_stm32_tpu.data.augment import apply_spec_augment as j_apply_spec_augment
from birdnet_stm32_tpu_torch.data import augment as A
from tests.test_torch_cpu_warmup import warm_up

warm_up()


def _jax_mixup_draw(key, B, alpha, probability, max_sources=3):
    """data/augment.py::apply_mixup's draws, in its order."""
    M = int(round(B * probability))
    k_rows, k_src, k_n, k_gain = jax.random.split(key, 4)
    rows = jax.random.permutation(k_rows, B)[:M]
    k_o1, k_o2 = jax.random.split(k_src)
    o1 = jax.random.randint(k_o1, (M,), 1, B)
    o2 = 1 + (o1 - 1 + jax.random.randint(k_o2, (M,), 1, max(B - 1, 2))) % max(B - 1, 1)
    n_sources = jax.random.randint(k_n, (M,), 2, max_sources + 1)
    gamma = jax.random.gamma(k_gain, alpha, (M, max_sources))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return A.MixupDraw(t(rows).long(), t(o1).long(), t(o2).long(), t(n_sources).long(),
                       t(gamma))


def _batch(seed, B, C, feature_shape=(16, 32, 1)):
    rng = np.random.default_rng(seed)
    x = rng.random((B, *feature_shape)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    return x, y


@pytest.mark.parametrize("B,alpha,probability,smoothing",
                         [(16, 0.2, 0.25, 0.0), (32, 0.5, 1.0, 0.1), (8, 2.0, 0.5, 0.0)])
def test_mix_with_jax_draws_matches_jax(B, alpha, probability, smoothing):
    x, y = _batch(B, B, 6)
    key = jax.random.key(B)
    jx, jy = j_apply_mixup(key, jnp.asarray(x), jnp.asarray(y), alpha=alpha,
                           probability=probability, label_smoothing=smoothing)
    draw = _jax_mixup_draw(key, B, alpha, probability)
    gx, gy = A.mix(torch.from_numpy(x), torch.from_numpy(y), draw, label_smoothing=smoothing)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))
    untouched = np.setdiff1d(np.arange(B), draw.rows.numpy())
    np.testing.assert_array_equal(gx.numpy()[untouched], x[untouched])


@pytest.mark.parametrize("shape,fmax,tmax", [((4, 32, 64, 1), 8, 16), ((3, 16, 32), 8, 25),
                                              ((2, 6, 20, 1), 8, 25)])
def test_masks_with_jax_draws_match_jax(shape, fmax, tmax):
    spec = np.random.default_rng(1).uniform(0.5, 1.0, shape).astype(np.float32)
    key = jax.random.key(shape[1])
    ref = np.asarray(j_apply_spec_augment(key, jnp.asarray(spec), freq_mask_max=fmax,
                                          time_mask_max=tmax))
    B, F, T = shape[:3]
    kf, kt = jax.random.split(key)
    draws = []
    for k, dim, mmax in ((kf, F, fmax), (kt, T, tmax)):
        ks = jax.random.split(k, 2)
        width = jax.random.randint(ks[0], (B, 2), 0, max(1, min(mmax, dim)))
        start = jax.random.randint(ks[1], (B, 2), 0, jnp.maximum(1, dim - width))
        draws.append((torch.from_numpy(np.array(width)).long(),
                      torch.from_numpy(np.array(start)).long()))
    got = A.mask_features(torch.from_numpy(spec), *draws).numpy()
    np.testing.assert_array_equal(got, ref)


def test_mixup_invariants_with_port_draws():
    g = torch.Generator().manual_seed(0)
    B, C = 32, 6
    x, y = _batch(2, B, C, (8,))
    draw = A.draw_mixup(g, B, alpha=0.5, probability=0.5)
    assert draw.rows.shape == (16,) and len(set(draw.rows.tolist())) == 16
    assert ((draw.o1 >= 1) & (draw.o1 < B) & (draw.o2 >= 1) & (draw.o2 < B)).all()
    assert (draw.o1 != draw.o2).all()
    assert ((draw.n_sources >= 2) & (draw.n_sources <= 3)).all()
    _, y2 = A.mix(torch.from_numpy(x), torch.from_numpy(y), draw)
    y2 = y2.numpy()
    assert set(np.unique(y2)).issubset({0.0, 1.0})
    assert (y2.sum(axis=1) >= 1).all() and (y2.sum(axis=1) <= 3).all()
    ones, _ = A.apply_mixup(g, torch.ones(8, 4), torch.from_numpy(y[:8]), alpha=0.3,
                            probability=1.0)
    np.testing.assert_allclose(ones.numpy(), 1.0, atol=1e-5)
    x2, y3 = A.apply_mixup(g, torch.from_numpy(x), torch.from_numpy(y), alpha=0.0,
                           probability=0.5, label_smoothing=0.1)
    assert torch.equal(x2, torch.from_numpy(x)) and y3.min() == pytest.approx(0.1 / C)
    changed = (A.apply_mixup(g, torch.from_numpy(x), torch.from_numpy(y), alpha=0.5,
                             probability=0.5)[0] != torch.from_numpy(x)).any(dim=1).sum()
    assert 1 <= changed <= B // 2


@pytest.mark.parametrize("alpha", [0.2, 2.5])
def test_gamma_draws_follow_their_law(alpha):
    g = torch.Generator().manual_seed(1)
    from scipy import stats

    n = 200_000
    d = A.gamma_draw(g, alpha, (n,), torch.device("cpu")).double()
    assert (d >= 0).all()
    assert abs(d.mean().item() - alpha) <= 4 * (alpha / n) ** 0.5
    assert abs(d.var().item() - alpha) <= 4 * ((2 * alpha**2 + 6 * alpha) / n) ** 0.5
    assert stats.kstest(d.numpy(), "gamma", args=(alpha,)).pvalue > 1e-3


def test_mask_law_with_port_draws():
    g = torch.Generator().manual_seed(2)
    width, start = A.draw_masks(g, 4000, 20, 8, 2)
    assert width.min() == 0 and width.max() == 7
    assert (start >= 0).all() and (start < torch.clamp_min(20 - width, 1)).all()
    assert start.max() == 19
    width, start = A.draw_masks(g, 100, 5, 8, 2)  # mask_max above the dim
    assert width.max() == 4 and (start < torch.clamp_min(5 - width, 1)).all()
    spec = torch.rand(4, 32, 64, 1, generator=g) + 0.5
    out = A.apply_spec_augment(g, spec, freq_mask_max=8, time_mask_max=16)
    zero = out[..., 0] == 0
    assert (zero == (out[..., 0] != spec[..., 0])).all()  # only masked cells change
    assert zero.all(dim=2).sum() <= 4 * 14 and zero.all(dim=1).sum() <= 4 * 30
    assert A.apply_spec_augment(g, spec[..., 0]).shape == (4, 32, 64)
    with pytest.raises(ValueError, match="channel"):
        A.apply_spec_augment(g, torch.rand(2, 8, 8, 2))
