"""PyTorch port, the training input pipeline against the JAX package.

Dataset discovery (class list, top-N, the per-class cap, minority
upsampling, one-hot rows with all-zero noise rows), the worker's
process_file and AudioLoader's batches are numpy code in both packages and
must be equal bit for bit for the same seed: float32, int16 (raw PCM16
codes + scale column) and mu-law rows, shuffled (reservoir + epoch-keyed
permutation) and FIFO, at num_workers=0 (the thread executor completes
files out of order, so only FIFO validation loaders compare across
executors). The files are mono PCM16 WAVs at the model rate (no
resampling), some long enough for smart_crop.

The batcher without augmentation against the JAX make_train_batcher on the
same int16 and mu-law batches: the dequant is bit-equal, the features
within 1e-5 (the kernel's plain version against the JAX composition, the
frontend tolerance of tests/test_pallas.py).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.data import dataset as JD
from birdnet_stm32_tpu.data.pipeline import AudioLoader as JAudioLoader
from birdnet_stm32_tpu.data.pipeline import make_train_batcher as j_make_train_batcher
from birdnet_stm32_tpu.data.worker import LoaderConfig as JLoaderConfig
from birdnet_stm32_tpu.data.worker import process_file as j_process_file
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.data import dataset as D
from birdnet_stm32_tpu_torch.data.pipeline import AudioLoader, LoaderConfig, make_train_batcher
from birdnet_stm32_tpu_torch.data.worker import process_file
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import TINY, write_wav_folder

warm_up()

SR = 4000
FEEDS = {"float32": {}, "int16": {"ship_int16": True}, "ulaw": {"ship_ulaw": True}}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = write_wav_folder(tmp_path_factory.mktemp("train_data") / "data", SR)
    # Long recordings (above 4 candidate chunks): the smart_crop path.
    rng = np.random.default_rng(9)
    from birdnet_stm32_tpu_torch.audio.io import save_wav

    for i, seconds in enumerate((6.5, 9.0)):
        t = np.arange(int(SR * seconds)) / SR
        burst = (np.sin(2 * np.pi * 0.3 * t) > 0.5) * np.sin(2 * np.pi * 900 * t)
        save_wav((0.6 * burst + rng.normal(0, 0.02, t.size)).astype(np.float32),
                 root / "b" / f"long_{i}.wav", SR)
    return root


def _discover(mod, root):
    paths, labels, classes = mod.load_file_paths_from_directory(root)
    rng = np.random.default_rng(3)
    capped = mod.load_file_paths_from_directory(root, max_samples_per_class=2, rng=rng)
    up = mod.upsample_minority_classes(paths[:7], labels[:7], 0.9, np.random.default_rng(4))
    return (paths, labels, classes, capped, up, mod.get_classes_with_most_samples(root, 2),
            mod.one_hot_labels(labels, classes))


def test_discovery_matches_jax(folder):
    got, ref = _discover(D, folder), _discover(JD, folder)
    assert got[:6] == ref[:6]
    np.testing.assert_array_equal(got[6], ref[6])
    paths, labels, classes = got[:3]
    assert classes == ["a", "b", "c"] and "noise" in labels
    assert not got[6][[lab == "noise" for lab in labels]].any()
    assert D.NOISE_LABELS == JD.NOISE_LABELS


def _tasks(folder, cfg):
    paths, labels, classes = D.load_file_paths_from_directory(folder)
    onehot = D.one_hot_labels(labels, classes)
    tasks = [(p, onehot[i], cfg, 7 * i) for i, p in enumerate(paths)]
    return tasks + [(str(folder / "missing.wav"), onehot[0], cfg, 1)]


@pytest.mark.parametrize("feed", list(FEEDS))
def test_process_file_bit_equal(folder, feed):
    """Every file (and a missing one: the noise fallback) through both
    workers, random offsets on."""
    kw = dict(sample_rate=SR, chunk_duration=1.0, num_classes=3, seed=5, **FEEDS[feed])
    for task in _tasks(folder, LoaderConfig(**kw)):
        got = process_file(task)
        ref = j_process_file((task[0], task[1], JLoaderConfig(**kw), task[3]))
        assert len(got) == len(ref) >= 1
        for (x, y), (jx, jy) in zip(got, ref):
            assert x.dtype == jx.dtype and x.shape == jx.shape
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def _loader_batches(cls, cfg_cls, folder, feed, shuffle, n_batches=6, **kw):
    paths, labels, classes = D.load_file_paths_from_directory(folder)
    cfg = cfg_cls(sample_rate=SR, chunk_duration=1.0, seed=11, max_chunks_per_file=2,
                  **FEEDS[feed])
    loader = cls(paths, D.one_hot_labels(labels, classes), cfg, batch_size=5,
                 shuffle=shuffle, infinite=shuffle, reservoir_size=16, **kw)
    out = []
    for x, y in loader:
        out.append((x, y))
        if len(out) == n_batches:
            break
    return out


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("feed", list(FEEDS))
def test_loader_batches_bit_equal(folder, feed, shuffle):
    got = _loader_batches(AudioLoader, LoaderConfig, folder, feed, shuffle, num_workers=0)
    ref = _loader_batches(JAudioLoader, JLoaderConfig, folder, feed, shuffle, num_workers=0)
    assert len(got) == len(ref) >= 5  # a FIFO loader ends with a partial batch
    for (x, y), (jx, jy) in zip(got, ref):
        assert x.dtype == jx.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_loader_workers(folder):
    """Two worker threads yield full shuffled batches; a FIFO (validation)
    loader gives the single-process batches whatever the executor, the
    process pool included."""
    got = _loader_batches(AudioLoader, LoaderConfig, folder, "int16", True, num_workers=2)
    assert len(got) == 6 and all(x.shape == (5, SR + 1) and x.dtype == np.int16 for x, _ in got)
    single = _loader_batches(AudioLoader, LoaderConfig, folder, "float32", False, num_workers=0)
    for executor in ("thread", "process"):
        fifo = _loader_batches(AudioLoader, LoaderConfig, folder, "float32", False,
                               num_workers=2, executor=executor, files_per_task=3)
        assert len(fifo) == len(single)
        for (x, y), (sx, sy) in zip(fifo, single):
            np.testing.assert_array_equal(x, sx)
            np.testing.assert_array_equal(y, sy)


def test_loader_config_guards():
    # The decoded-waveform cache is ported (tests/test_torch_waveform_cache.py).
    assert LoaderConfig(cache_dir="/nonexistent").cache_dir == "/nonexistent"
    cfg = LoaderConfig(ship_int16=True, ship_ulaw=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        process_file(("x.wav", np.zeros(2, np.float32), cfg, 0))
    with pytest.raises(ValueError, match="does not match"):
        AudioLoader(["x.wav"], np.zeros((1, 3), np.float32), LoaderConfig(num_classes=2))


@pytest.mark.parametrize("feed", ["int16", "ulaw"])
def test_batcher_without_augmentation_matches_jax(folder, feed):
    x, y = _loader_batches(AudioLoader, LoaderConfig, folder, feed, True, n_batches=1,
                           num_workers=0)[0]
    kw = dict(TINY, audio_frontend="hybrid")
    ref_x, ref_y = j_make_train_batcher(JaxModelConfig(**kw), spec_augment=False,
                                        mixup_probability=0.0, input_dtype=feed)(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    got_x, got_y = make_train_batcher(ModelConfig(**kw), spec_augment=False,
                                      mixup_probability=0.0, input_dtype=feed)(
        None, torch.from_numpy(x), torch.from_numpy(y))
    assert got_x.shape == ref_x.shape == (5, 65, 32, 1)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(ref_y))


def test_batcher_augments_with_its_generator(folder):
    """SpecAugment + mixup on the int16 feed: shapes kept, a fixed count of
    rows mixed, the same generator state giving the same batch."""
    x, y = _loader_batches(AudioLoader, LoaderConfig, folder, "int16", True, n_batches=1,
                           num_workers=0)[0]
    batcher = make_train_batcher(ModelConfig(**TINY), mixup_probability=0.4,
                                 input_dtype="int16")
    outs = [batcher(torch.Generator().manual_seed(3), torch.from_numpy(x), torch.from_numpy(y))
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert outs[0][0].shape == (5, 65, 32, 1)
    plain = make_train_batcher(ModelConfig(**TINY), spec_augment=False, mixup_probability=0.0,
                               input_dtype="int16")(None, torch.from_numpy(x), torch.from_numpy(y))
    assert (outs[0][1] != plain[1]).any(dim=1).sum() <= 2  # round(5 * 0.4) rows mixed
    with pytest.raises(ValueError, match="input_dtype"):
        make_train_batcher(ModelConfig(**TINY), input_dtype="int8")
