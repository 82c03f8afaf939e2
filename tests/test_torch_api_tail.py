"""PyTorch port, the public functions that rode with the convert and deploy
slice: the model registry (models/__init__.py), combine_species_lists,
load_tflite_model, stft_magnitude_host and the host spectrogram API
(audio/spectrogram.py), against the JAX package.

Tolerances: the registry, species lists and stft_magnitude_host (the same
numpy code) equal; load_tflite_model's scores bit-equal to the jitted JAX
executor's (the committed goldens); get_spectrogram_from_audio within 1e-5
of the JAX one (the composition's gate), and stft_magnitude_host within
1e-5 of the port's torch stft_magnitude (unit-scale magnitudes of a
float32 DFT against a float64 FFT).
"""

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu import models as JMODELS
from birdnet_stm32_tpu.audio import spectrogram as JSPEC
from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.data import species as JSP
from birdnet_stm32_tpu.ops.stft import stft_magnitude_host as j_stft_host
from birdnet_stm32_tpu_torch import models as PMODELS
from birdnet_stm32_tpu_torch.audio import spectrogram as PSPEC
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.data import species as PSP
from birdnet_stm32_tpu_torch.models.dscnn import DSCNN
from birdnet_stm32_tpu_torch.ops.stft import stft_magnitude, stft_magnitude_host
from birdnet_stm32_tpu_torch.quant.tflite_import import load_tflite_model
from tests.int8_fixture import FLAGSHIP_TFLITE, flagship_features
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_tflite import GOLDEN
from tests.torch_fuzz_fixtures import load as load_fuzz
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401

warm_up()

SMALL = dict(sample_rate=4000, num_mels=16, spec_width=32, fft_length=128,
             chunk_duration=1.0, embeddings_size=32, num_classes=3,
             class_names=["a", "b", "c"], alpha=0.25)


def test_model_registry_matches_jax():
    # The port's registry holds the JAX package's one model and its own
    # EfficientNet-B1.
    assert JMODELS.list_models() == ["dscnn"]
    assert PMODELS.list_models() == ["dscnn", "efficientnet_b1"]
    cfg = ModelConfig(**SMALL)
    model = PMODELS.build_model("dscnn", cfg, class_activation="none", device="cpu")
    assert isinstance(model, DSCNN) and model.class_activation == "none"
    jmodel = JMODELS.build_model("dscnn", JaxModelConfig(**SMALL), class_activation="none")
    assert jmodel.class_activation == "none"
    for mod in (PMODELS, JMODELS):
        with pytest.raises(KeyError, match="no model builder registered under 'nope'"):
            mod.build_model("nope", cfg)
        with pytest.raises(ValueError, match="a model builder named 'dscnn' exists"):
            mod.register_model("dscnn")(lambda cfg: None)
    try:
        @PMODELS.register_model("tiny_test")
        def build(cfg, **kw):
            return ("built", cfg.num_classes, kw)

        assert PMODELS.list_models() == ["dscnn", "efficientnet_b1", "tiny_test"]
        assert PMODELS.build_model("tiny_test", cfg, k=1) == ("built", 3, {"k": 1})
    finally:
        PMODELS._MODEL_REGISTRY.pop("tiny_test", None)


@pytest.mark.parametrize("max_species", [None, 3])
def test_combine_species_lists_equals_jax(tmp_path, max_species):
    lists = []
    for i, names in enumerate((["wren", "crow", "wren", "jay"], ["owl", "crow", "tit"],
                               ["kite"])):
        lists.append(tmp_path / f"l{i}.txt")
        lists[-1].write_text("\n".join(names) + "\n\n")
    got = PSP.combine_species_lists(lists, tmp_path / "p.txt", max_species)
    ref = JSP.combine_species_lists(lists, tmp_path / "j.txt", max_species)
    assert got == ref
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_load_tflite_model_equals_jax_golden(tmp_path):
    """The flagship graph's executor on the golden's features, and fuzz
    graph 7's on its features (JAX's jitted executor wrote both goldens)."""
    graph, run = load_tflite_model(FLAGSHIP_TFLITE, batch_size=8, device="cpu")
    assert len(graph.ops) == 57
    got = run(torch.from_numpy(flagship_features(8))).numpy()
    golden = np.load(GOLDEN)["scores"]
    assert np.ptp(golden) > 0.5  # scores that vary
    np.testing.assert_array_equal(got, golden)
    f = load_fuzz(7)
    path = tmp_path / "fuzz7.tflite"
    path.write_bytes(f.tflite)
    _, run = load_tflite_model(path, batch_size=len(f.features), device="cpu")
    np.testing.assert_array_equal(run(torch.from_numpy(f.features)).numpy(), f.int8_exact)


@pytest.mark.parametrize("n_fft,hop,center,n_frames", [(128, 125, True, None),
                                                       (512, 258, True, 40),
                                                       (256, 64, False, None)])
def test_stft_magnitude_host_equals_jax(n_fft, hop, center, n_frames):
    y = np.random.default_rng(0).normal(0, 0.3, 4000).astype(np.float32)
    got = stft_magnitude_host(y, n_fft, hop, center=center, n_frames=n_frames)
    ref = j_stft_host(y, n_fft, hop, center=center, n_frames=n_frames)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    W = got.shape[1]
    if center:
        dev = stft_magnitude(torch.from_numpy(y)[None], n_fft, hop, W)[0].numpy().T
        np.testing.assert_allclose(dev, got, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode,mag", [("mel", "none"), ("mel", "pwl"), ("mel", "db"),
                                      ("log_mel", "none"), ("mfcc", "none"),
                                      ("linear", "none")])
def test_get_spectrogram_from_audio_matches_jax(mode, mag):
    y = np.random.default_rng(1).normal(0, 0.3, 4000).astype(np.float32)
    kw = dict(sample_rate=4000, n_fft=128, mel_bins=16, spec_width=32, mag_scale=mag,
              mode=mode)
    got = PSPEC.get_spectrogram_from_audio(y, device="cpu", **kw)
    ref = JSPEC.get_spectrogram_from_audio(y, **kw)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert PSPEC.VALID_MODES == JSPEC.VALID_MODES
    with pytest.raises(ValueError, match="1D mono"):
        PSPEC.get_spectrogram_from_audio(y[None], device="cpu")
    if not torch.cuda.is_available():
        # The card is the default; without one the call raises, never
        # falls back to the CPU.
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PSPEC.get_spectrogram_from_audio(y, **kw)
    s = np.random.default_rng(2).normal(size=(5, 7))
    np.testing.assert_array_equal(PSPEC.normalize(s), JSPEC.normalize(s))
