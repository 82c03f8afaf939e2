"""PyTorch port, the .keras transplant (models/transplant.py) against the
JAX package's.

The reference checkpoints are not in the repo, so the archives are written
here (tests/torch_keras_archive.py) from Flax trees of JAX's init_model
with every leaf moved off its init value, in seven configurations: hybrid
pwl, hybrid pcen, raw (with the filterbank BN), librosa, plain DS + SE,
inverted residual + SE + attention pooling, and pwl under the newer
`mag_layer/` prefix. On each: JAX's transplant_params returns the tree that
was written, the port's state_dict equals flax_to_state_dict of JAX's tree
bit for bit, and the port's scores are within 1e-5 of JAX's model.apply
(both float32, differing in summation order, as tests/test_torch_model.py).
One archive saved by keras itself pins Keras 3's real per-class h5 group
counters.
"""

import dataclasses
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models import transplant as J
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.dscnn import init_model as j_init_model
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models import transplant as P
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_keras_archive import write_keras_archive
from tests.torch_train_fixtures import TINY, one_torch_thread  # noqa: F401

warm_up()

CONFIGS = {
    "hybrid_pwl": ({}, ""),
    "hybrid_pcen": (dict(mag_scale="pcen"), ""),
    "raw_fb_bn": (dict(audio_frontend="raw"), ""),
    "librosa": (dict(audio_frontend="librosa", mag_scale="none"), ""),
    "ds_se": (dict(use_se=True), ""),
    "ir_se_attention": (dict(use_se=True, use_inverted_residual=True,
                             use_attention_pooling=True), ""),
    "hybrid_pwl_mag_layer": ({}, "mag_layer/"),
}
ACTIVATION = {"ds_se": "sigmoid"}  # the head comes from the graph


def _perturbed_tree(jcfg, seed: int) -> dict:
    """Numpy Flax tree of JAX's init_model with every leaf moved: BN scale
    and var positive, the mel mixer non-negative, kernels scaled."""
    rng = np.random.default_rng(seed)
    v = jax.device_get(j_init_model(j_build_dscnn(jcfg), jcfg, jax.random.key(seed)))

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        name = str(path[-1].key)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("kernel", "mel_mixer"):
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a + rng.normal(0.0, 0.05, a.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, v)
    return jax.tree_util.tree_map(np.asarray, {k: dict(tree[k]) for k in tree})


def _plain(tree):
    """Nested dicts of numpy arrays, empty dicts dropped (a frontend with no
    weights reads back as an empty group)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            v = _plain(v)
            if v:
                out[k] = v
        else:
            out[k] = np.asarray(v)
    return out


def _assert_trees_equal(a, b):
    a, b = _plain(a), _plain(b)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module", params=list(CONFIGS))
def archive(request, tmp_path_factory):
    overrides, prefix = CONFIGS[request.param]
    kw = dict(TINY, **overrides)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    tree = _perturbed_tree(jcfg, seed=len(request.param))
    root = tmp_path_factory.mktemp(request.param)
    path = write_keras_archive(root / "m.keras", tree,
                               class_activation=ACTIVATION.get(request.param, "softmax"),
                               mag_prefix=prefix)
    # The sidecar predates the toggles: the graph must set them.
    side = dataclasses.replace(cfg, use_se=not cfg.use_se, use_attention_pooling=False)
    side.save(root / "m_model_config.json")
    return dict(name=request.param, path=path, tree=tree, jcfg=jcfg, cfg=cfg,
                config_path=root / "m_model_config.json")


def test_jax_transplant_reads_the_written_tree(archive):
    variables, arch = J.transplant_params(archive["path"], archive["jcfg"])
    _assert_trees_equal(jax.device_get(variables), archive["tree"])
    assert arch["class_activation"] == ACTIVATION.get(archive["name"], "softmax")


def test_port_tree_and_state_dict_equal_jax(archive):
    jvars, jarch = J.transplant_params(archive["path"], archive["jcfg"])
    jvars = _plain(jax.device_get(jvars))
    pvars, parch = P.transplant_variables(archive["path"], archive["cfg"])
    _assert_trees_equal(pvars, jvars)
    assert parch == jarch
    sd, _ = P.transplant_params(archive["path"], archive["cfg"])
    ref = flax_to_state_dict(jvars)
    assert sd.keys() == ref.keys()
    for k in sd:
        assert sd[k].dtype == ref[k].dtype and torch.equal(sd[k], ref[k]), k


def test_port_scores_match_jax(archive):
    jmodel, jvars, jcfg = J.load_reference_model(archive["path"], archive["config_path"])
    model, sd, cfg = P.load_reference_model(archive["path"], archive["config_path"],
                                            device="cpu")
    assert (cfg.use_se, cfg.use_inverted_residual, cfg.use_attention_pooling) == (
        jcfg.use_se, jcfg.use_inverted_residual, jcfg.use_attention_pooling) == (
        archive["cfg"].use_se, archive["cfg"].use_inverted_residual,
        archive["cfg"].use_attention_pooling)
    assert model.class_activation == ACTIVATION.get(archive["name"], "softmax")
    x = np.random.default_rng(1).uniform(0, 1, (3, *cfg.input_shape())).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, cfg.num_classes)
    np.testing.assert_allclose(got, ref, atol=1e-5)


LOOKALIKES = [
    ("stem_conv", "probe_sep", "mixer_ir10n", "stage1_ds1_dw", "pred"),
    ("stage1_ds1_dw", "stage1_se1_squeeze", "stage1_se1_reduce"),
    ("stage2_ir3_expand", "stage2_ir3_se_squeeze"),
    ("stage1_se_extra", "stage1_ir_dw", "xstage1_ir1_dw", "stage1_se1_reducer"),
]


@pytest.mark.parametrize("names", LOOKALIKES)
def test_detect_arch_matches_jax_on_lookalikes(names):
    layers = [{"class_name": "Conv2D", "name": n, "config": {}} for n in names]
    layers.append({"class_name": "Dense", "name": "pred", "config": {"activation": "sigmoid"}})
    assert P.detect_arch(layers) == J.detect_arch(layers)
    plain = P.detect_arch(layers)
    expect = {LOOKALIKES[0]: (False, False), LOOKALIKES[1]: (True, False),
              LOOKALIKES[2]: (True, True), LOOKALIKES[3]: (False, False)}[names]
    assert (plain["use_se"], plain["use_inverted_residual"]) == expect


def test_keras_saved_archive_counters(tmp_path):
    """A tiny functional model saved by keras itself: repeated Conv2D,
    DepthwiseConv2D, BatchNormalization and Dense. Both packages name its
    h5 groups alike and read keras's own weights from them."""
    keras = pytest.importorskip("keras")
    L = keras.layers
    inp = keras.Input((8, 8, 1))
    x = L.Conv2D(4, 3, padding="same", name="stem_conv")(inp)
    x = L.BatchNormalization(name="stem_bn")(x)
    x = L.ReLU(name="stem_relu")(x)
    x = L.DepthwiseConv2D(3, padding="same", use_bias=False, name="stage1_ds1_dw")(x)
    x = L.BatchNormalization(name="stage1_ds1_dw_bn")(x)
    x = L.Conv2D(6, 1, use_bias=False, name="stage1_ds1_pw")(x)
    x = L.BatchNormalization(name="stage1_ds1_pw_bn")(x)
    x = L.DepthwiseConv2D(3, padding="same", use_bias=False, name="stage1_ds2_dw")(x)
    x = L.GlobalAveragePooling2D(name="gap")(x)
    x = L.Dense(5, name="emb_dense")(x)
    x = L.Dense(3, activation="sigmoid", name="pred")(x)
    model = keras.Model(inp, x)
    rng = np.random.default_rng(0)
    for layer in model.layers:
        layer.set_weights([rng.normal(size=w.shape).astype(np.float32)
                           for w in layer.get_weights()])
    path = tmp_path / "k.keras"
    model.save(path)

    graph, h5 = J.read_keras_archive(path)
    pgraph, ph5 = P.read_keras_archive(path)
    layers = graph["config"]["layers"]
    assert pgraph == graph
    names = P.layer_h5_names(layers)
    assert names == J.layer_h5_names(layers)
    assert names["stage1_ds1_pw_bn"] == "batch_normalization_2"
    assert names["stage1_ds2_dw"] == "depthwise_conv2d_1"
    assert names["pred"] == "dense_1"
    for layer in model.layers:
        if not layer.get_weights():
            continue
        got, ref = P._vars(ph5, names[layer.name]), J._vars(h5, names[layer.name])
        assert len(got) == len(ref) == len(layer.get_weights())
        for g, r, w in zip(got, ref, layer.get_weights()):
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, w)
    assert P.detect_arch(layers)["class_activation"] == "sigmoid"
    # The transplant maps keras's depthwise layout to Flax's.
    cfg = ModelConfig(**TINY)
    pvars, _ = P.transplant_variables(path, cfg)
    jvars, _ = J.transplant_params(path, JaxModelConfig(**TINY))
    _assert_trees_equal(pvars, jax.device_get(jvars))
    dw = model.get_layer("stage1_ds1_dw").get_weights()[0]
    np.testing.assert_array_equal(pvars["params"]["stage1_ds1_dw"]["kernel"],
                                  np.transpose(dw, (0, 1, 3, 2)))


def _edit_h5(path, edit) -> None:
    """Rewrite the archive's weights file through edit(h5)."""
    import io

    import h5py

    with zipfile.ZipFile(path) as z:
        files = {n: z.read(n) for n in z.namelist()}
    buf = io.BytesIO(files["model.weights.h5"])
    with h5py.File(buf, "a") as h5:
        edit(h5)
    files["model.weights.h5"] = buf.getvalue()
    with zipfile.ZipFile(path, "w") as z:
        for n, b in files.items():
            z.writestr(n, b)


def test_depth_multiplier_refused(tmp_path):
    path = write_keras_archive(tmp_path / "m.keras",
                               _perturbed_tree(JaxModelConfig(**TINY), seed=0))

    def multiplier_two(h5):
        del h5["layers/depthwise_conv2d/vars/0"]
        h5["layers/depthwise_conv2d/vars"].create_dataset("0", data=np.zeros((3, 3, 8, 2),
                                                                              np.float32))

    _edit_h5(path, multiplier_two)
    with pytest.raises(NotImplementedError, match="depth_multiplier=2"):
        P.transplant_params(path, ModelConfig(**TINY))


def test_missing_sibling_raises(tmp_path):
    """A pwl frontend with one sublayer's weight missing names it, in both
    packages."""
    path = write_keras_archive(tmp_path / "m.keras",
                               _perturbed_tree(JaxModelConfig(**TINY), seed=0))

    def drop_bias(h5):
        del h5["layers/audio_frontend_layer/_pwl_shift_dws/depthwise_conv2d_1/vars/1"]

    _edit_h5(path, drop_bias)
    for mod, cfg in ((P, ModelConfig(**TINY)), (J, JaxModelConfig(**TINY))):
        with pytest.raises(KeyError, match="_pwl_shift_dws/depthwise_conv2d_1 bias"):
            mod.transplant_params(path, cfg)


def test_graph_config_is_json(archive):
    with zipfile.ZipFile(archive["path"]) as z:
        graph = json.loads(z.read("config.json"))
    assert graph["config"]["layers"][-1]["name"] == "pred"


def test_committed_flagship_archive():
    """The fixture (tests/make_torch_transplant_fixtures.py): the port's and
    JAX's transplants of the flagship-geometry archive are the committed
    weights bit for bit, and the h5py-free route of chip_smoke.py builds
    the same model as load_model_runner."""
    from birdnet_stm32_tpu_torch.models.runners import TorchRunner, load_model_runner
    from tests import make_torch_transplant_fixtures as TF

    cfg = ModelConfig.load(TF.SIDECAR)
    committed = TF.load_state_dict()
    sd, arch = P.transplant_params(TF.KERAS, cfg)
    jvars, jarch = J.transplant_params(TF.KERAS, JaxModelConfig.load(TF.SIDECAR))
    ref = flax_to_state_dict(_plain(jax.device_get(jvars)))
    assert arch == jarch and arch["class_activation"] == "softmax"
    assert sd.keys() == committed.keys() == ref.keys()
    for k in sd:
        assert torch.equal(sd[k], committed[k]) and torch.equal(sd[k], ref[k]), k
    runner = load_model_runner(TF.KERAS, device="cpu")
    model, rcfg = TF.archive_model(device="cpu")
    assert isinstance(runner, TorchRunner) and rcfg == runner.cfg
    assert model.class_activation == runner.model.class_activation == "softmax"
    x = np.random.default_rng(2).uniform(0, 1, (2, *cfg.input_shape())).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_array_equal(model(torch.from_numpy(x)).numpy(), runner.predict(x))


def test_serve_and_profile_verbs_on_keras(tmp_path, capsys):
    """`serve` on the archive (its sidecar derived) equals the API's pooled
    scores; `profile` of the archive prints what the JAX verb prints."""
    from birdnet_stm32_tpu.cli.profile import main as jprofile
    from birdnet_stm32_tpu_torch.__main__ import main as verb
    from birdnet_stm32_tpu_torch.audio.io import save_wav
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner
    from birdnet_stm32_tpu_torch.models.serving import decode_for_classify, make_fused_classifier
    from tests import make_torch_transplant_fixtures as TF

    cfg = ModelConfig.load(TF.SIDECAR)
    t = np.arange(int(4.2 * cfg.sample_rate)) / cfg.sample_rate
    wav = tmp_path / "audio" / "chirp.wav"
    save_wav((0.5 * np.sin(2 * np.pi * 2000 * t * (1 + 0.2 * t))).astype(np.float32), wav,
             cfg.sample_rate)
    out = tmp_path / "r.tsv"
    assert verb(["serve", "--model_path", str(TF.KERAS), "--audio_dir", str(wav.parent),
                 "--results_file", str(out), "--batch_size", "4", "--once",
                 "--device", "cpu"]) == 0
    name, *vals = out.read_text().strip().split("\t")
    got = np.array([float(v) for v in vals])
    chunks, _, _, _ = decode_for_classify(wav, cfg)
    classify = make_fused_classifier(load_model_runner(TF.KERAS, device="cpu"), cfg,
                                     device="cpu")
    ref = classify(chunks).mean(axis=0)
    assert name == "chirp.wav" and got.shape == (100,)
    np.testing.assert_allclose(got, ref, atol=1e-4)  # the TSV's 4 decimals
    capsys.readouterr()
    assert verb(["profile", "--model_path", str(TF.KERAS)]) == 0
    port_out = capsys.readouterr().out
    assert jprofile(["--model_path", str(TF.KERAS)]) == 0
    assert port_out == capsys.readouterr().out and "224,388" in port_out
