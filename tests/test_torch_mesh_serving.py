"""PyTorch port, serving over a local mesh: parallel/mesh.py (local_mesh,
shard_batch, gather, replicated), parallel/steps.py::make_infer_fn, the
runners' mesh= and make_fused_classifier / make_embedder /
make_classifier_cache under it, against the JAX package's sharded runners
and classifier on the 8-device CPU mesh of tests/conftest.py. The port's
mesh is ["cpu"] * k: the split and the gather are the same on one device.

Tolerances (those of the unsharded comparisons):
- INT8: bit-equal. The runners on a tiny conv graph (tests/int8_fixture.py,
  outputs that vary) against the JAX sharded runner; the fuzz graph's
  classifier against the JAX sharded classifier; the flagship graph and
  its fused-entry fixture under every ingress (float32, int16, mu-law,
  48 kHz resampled) against the port without a mesh.
- float32: scores within 5e-5 (tests/test_torch_serving.py's tolerance
  between the packages), logits within LOGIT_SPREAD_RTOL of each row's
  spread (tests/torch_fuzz_fixtures.py), embeddings within 1e-4 relative
  (tests/test_torch_ingress.py).
- bf16: logits at per-row cosine >= BF16_LOGIT_MIN_COSINE (0.99).
- A mesh of one device equals no mesh bit for bit on every leg.
- A batch that does not divide over the mesh raises ValueError, in both
  packages (JAX's sharded jit refuses the argument's sharding).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.models import serving as J
from birdnet_stm32_tpu.models.dscnn import build_dscnn as j_build_dscnn
from birdnet_stm32_tpu.models.runners import FlaxRunner
from birdnet_stm32_tpu.models.runners import TFLiteSimRunner as JTFLiteSimRunner
from birdnet_stm32_tpu.parallel.mesh import make_mesh as j_make_mesh
from birdnet_stm32_tpu.parallel.steps import make_infer_fn as j_make_infer_fn
from birdnet_stm32_tpu.quant import tflite_import as j_tflite_import
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.models import serving as P
from birdnet_stm32_tpu_torch.models.convert import flax_to_state_dict
from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn
from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, TorchRunner
from birdnet_stm32_tpu_torch.parallel import mesh as M
from birdnet_stm32_tpu_torch.parallel.steps import make_infer_fn
from birdnet_stm32_tpu_torch.quant import tflite_import
from tests.int8_fixture import FLAGSHIP_TFLITE, entry_transpose_fixture, tiny_conv_graph
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_ingress import FLAGSHIP_CONFIG, _raw_batch
from tests.torch_fuzz_fixtures import bf16_logits_match, load, logits_match
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401

warm_up()

WIDTHS = (2, 8)
B = 8  # divides over every width
FUZZ = 0  # hybrid + pwl, softmax head: logits that vary
SCORE_ATOL = 5e-5
CPU = torch.device("cpu")


def _cpu_mesh(k: int) -> list[str]:
    return ["cpu"] * k


@functools.lru_cache(maxsize=None)
def _fuzz():
    """(fixture, JAX cfg, port cfg, seeded waves [B, T], seeded features)."""
    f = load(FUZZ)
    rng = np.random.default_rng(11)
    waves = rng.normal(0, 0.3, (B, f.cfg["sample_rate"])).astype(np.float32)
    feats = rng.uniform(0, 1, (B, *f.features.shape[1:])).astype(np.float32)
    return f, JaxModelConfig.from_dict(f.cfg), ModelConfig.from_dict(f.cfg), waves, feats


def _jax_runner(k: int | None, activation: str, dtype=None) -> FlaxRunner:
    f, jcfg, *_ = _fuzz()
    mesh = None if k is None else j_make_mesh(jax.devices()[:k])
    return FlaxRunner(j_build_dscnn(jcfg, class_activation=activation),
                      jax.tree_util.tree_map(jnp.asarray, f.variables), jcfg,
                      mesh=mesh, dtype=dtype)


def _port_model(activation: str) -> torch.nn.Module:
    f, _, cfg, *_ = _fuzz()
    model = build_dscnn(cfg, class_activation=activation, device="cpu")
    model.load_state_dict(flax_to_state_dict(f.variables), strict=True)
    return model


def _port_runner(k: int | None, activation: str, dtype=None) -> TorchRunner:
    mesh = None if k is None else _cpu_mesh(k)
    return TorchRunner(_port_model(activation), _fuzz()[2], dtype=dtype, mesh=mesh,
                       device=None if k else "cpu")


def _tiny_graph(module):
    return tiny_conv_graph(module, "SAME", (1, 1), (1, 1), 1)


def test_mesh_helpers():
    """local_mesh resolves each entry; shard_batch splits rows in mesh order
    and refuses a batch that does not divide; gather restores the order;
    replicated keeps a module where it lies and copies tensors."""
    assert M.local_mesh(["cpu", torch.device("cpu")]) == [CPU, CPU]
    with pytest.raises(ValueError, match="at least one"):
        M.local_mesh([])
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    for batch in (x, torch.from_numpy(x)):
        blocks = M.shard_batch(batch, [CPU] * 3)
        assert [tuple(b.shape) for b in blocks] == [(2, 4)] * 3
        assert all(isinstance(b, torch.Tensor) for b in blocks)
        np.testing.assert_array_equal(M.gather(blocks, CPU).numpy(), x)
        with pytest.raises(ValueError, match="does not divide"):
            M.shard_batch(batch, [CPU] * 4)
    one = M.shard_batch(x, [CPU])
    assert len(one) == 1 and np.shares_memory(one[0].numpy(), x)
    assert M.gather(one, CPU) is one[0]
    model = torch.nn.Linear(3, 2)
    reps = M.replicated(model, [CPU, CPU])
    assert list(reps) == [CPU] and reps[CPU] is model
    tree = M.replicated({"w": torch.ones(2), "pair": (torch.zeros(1), 3)}, [CPU])
    assert torch.equal(tree[CPU]["w"], torch.ones(2)) and tree[CPU]["pair"][1] == 3


def test_local_mesh_defaults_to_every_card():
    """local_mesh() lists every visible CUDA device; without CUDA it raises,
    as every entry point's default device does."""
    if torch.cuda.is_available():
        assert M.local_mesh() == [torch.device("cuda", i)
                                  for i in range(torch.cuda.device_count())]
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.local_mesh()


def test_runner_device_is_the_first_of_the_mesh():
    model = _port_model("softmax")
    r = TorchRunner(model, _fuzz()[2], mesh=["cpu", "cpu"])
    assert r.mesh == [CPU, CPU] and r.device == CPU and list(r.replicas) == [CPU]
    assert TorchRunner(model, _fuzz()[2], device="cpu", mesh=["cpu"]).device == CPU
    with pytest.raises(ValueError, match="first device"):
        TorchRunner(model, _fuzz()[2], device="meta", mesh=["cpu"])
    with pytest.raises(ValueError, match="first device"):
        TFLiteSimRunner(_tiny_graph(tflite_import), device="meta", mesh=["cpu"])
    assert TorchRunner(model, _fuzz()[2], device="cpu").mesh is None


def test_indivisible_batch_raises_in_both():
    """Six rows over eight devices: JAX's sharded jit and the port's mesh
    both raise ValueError, on the runner and on the classifier."""
    f, jcfg, cfg, waves, feats = _fuzz()
    jrunner = _jax_runner(8, "softmax")
    with pytest.raises(ValueError):
        jrunner.predict(feats[:6])
    with pytest.raises(ValueError):
        J.make_fused_classifier(jrunner, jcfg)(waves[:6])
    runner = _port_runner(8, "softmax")
    with pytest.raises(ValueError, match="does not divide"):
        runner.predict(feats[:6])
    with pytest.raises(ValueError, match="does not divide"):
        P.make_fused_classifier(runner, cfg, device="cpu")(waves[:6])
    with pytest.raises(ValueError, match="does not divide"):
        TFLiteSimRunner(_tiny_graph(tflite_import), mesh=_cpu_mesh(8)).predict(
            np.zeros((6, 9, 7, 3), np.float32))


@pytest.mark.parametrize("k", WIDTHS)
def test_float_leg_matches_jax_sharded(k):
    """The sharded float32 runner (make_infer_fn under it) and classifier
    against JAX's FlaxRunner(mesh=) and its sharded classifier: scores and
    logits, on seeded features and waveforms."""
    f, jcfg, cfg, waves, feats = _fuzz()
    for activation in ("softmax", "none"):
        jrunner, runner = _jax_runner(k, activation), _port_runner(k, activation)
        ref = np.asarray(jrunner.predict(feats))
        got = runner.predict(feats)
        infer = make_infer_fn(_port_model(activation), _cpu_mesh(k))
        np.testing.assert_array_equal(infer(torch.from_numpy(feats)).numpy(), got)
        ref_classify = np.asarray(J.make_fused_classifier(jrunner, jcfg)(waves))
        got_classify = P.make_fused_classifier(runner, cfg, device="cpu")(waves)
        if activation == "softmax":
            np.testing.assert_allclose(got, ref, atol=SCORE_ATOL)
            np.testing.assert_allclose(got_classify, ref_classify, atol=SCORE_ATOL)
        else:
            assert logits_match(got, ref) and logits_match(got_classify, ref_classify)
    # JAX's make_infer_fn over the mesh, which its FlaxRunner(mesh=) runs.
    jinfer = j_make_infer_fn(jrunner.model, jrunner.variables, mesh=j_make_mesh(
        jax.devices()[:k]))
    assert logits_match(got, np.asarray(jinfer(jnp.asarray(feats))))


@pytest.mark.parametrize("k", WIDTHS)
def test_bf16_leg_matches_jax_sharded(k):
    f, jcfg, cfg, waves, _ = _fuzz()
    jrunner = _jax_runner(k, "none", jnp.bfloat16)
    runner = _port_runner(k, "none", torch.bfloat16)
    assert {p.dtype for p in runner.replicas[CPU].parameters()} == {torch.bfloat16}
    ref = np.asarray(J.make_fused_classifier(jrunner, jcfg)(waves))
    got = P.make_fused_classifier(runner, cfg, device="cpu")(waves)
    assert got.dtype == np.float32 and bf16_logits_match(got, ref)


@pytest.mark.parametrize("k", WIDTHS)
def test_int8_leg_bit_equal_jax_sharded(k):
    """The sharded INT8 runner on a tiny conv graph (outputs that vary), and
    the sharded classifier on the fuzz configuration's graph, bit-equal to
    JAX's TFLiteSimRunner(mesh=) and its sharded classifier."""
    f, jcfg, cfg, waves, _ = _fuzz()
    jmesh = j_make_mesh(jax.devices()[:k])
    jtiny = JTFLiteSimRunner(str(FLAGSHIP_TFLITE), mesh=jmesh)
    jtiny.graph = _tiny_graph(j_tflite_import)
    x = np.random.default_rng(12).uniform(-1, 1, (B, 9, 7, 3)).astype(np.float32)
    ref = np.asarray(jtiny.predict(x))
    tiny = TFLiteSimRunner(_tiny_graph(tflite_import), mesh=_cpu_mesh(k))
    got = tiny.predict(x)
    assert np.ptp(ref) > 0 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tiny.forward(torch.from_numpy(x)).numpy(), ref)

    jfuzz = JTFLiteSimRunner(str(FLAGSHIP_TFLITE), mesh=jmesh)
    jfuzz.graph = j_tflite_import.TFLiteGraph(f.tflite)
    ref = np.asarray(J.make_fused_classifier(jfuzz, jcfg)(waves))
    got = P.make_fused_classifier(TFLiteSimRunner(f.tflite, mesh=_cpu_mesh(k)), cfg,
                                  device="cpu")(waves)
    np.testing.assert_array_equal(got, ref)


def test_width_one_equals_no_mesh():
    """A mesh of one device is the unsharded path, bit for bit: float32 and
    bf16 classifiers and embedders, the INT8 runner and classifier."""
    f, jcfg, cfg, waves, feats = _fuzz()
    for dtype in (None, torch.bfloat16):
        one, none = _port_runner(1, "none", dtype), _port_runner(None, "none", dtype)
        for make in (P.make_fused_classifier, P.make_embedder):
            np.testing.assert_array_equal(make(one, cfg, device="cpu")(waves),
                                          make(none, cfg, device="cpu")(waves))
        np.testing.assert_array_equal(one.predict(feats), none.predict(feats))
    x = np.random.default_rng(13).uniform(-1, 1, (B, 9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TFLiteSimRunner(_tiny_graph(tflite_import), mesh=["cpu"]).predict(x),
        TFLiteSimRunner(_tiny_graph(tflite_import), device="cpu").predict(x))
    fcfg = ModelConfig.load(FLAGSHIP_CONFIG)
    wave = np.random.default_rng(14).normal(0, 0.2, (2, fcfg.chunk_samples)).astype(np.float32)
    one, none = (P.make_fused_classifier(TFLiteSimRunner(FLAGSHIP_TFLITE, device="cpu",
                                                         mesh=mesh), fcfg, device="cpu")(wave)
                 for mesh in (["cpu"], None))
    np.testing.assert_array_equal(one, none)


@pytest.mark.parametrize("k", WIDTHS)
def test_embedder_and_cache_follow_the_mesh(k):
    """make_embedder over a mesh against JAX's sharded embedder, and
    make_classifier_cache's classifiers over the mesh (int16 ingress, input
    at twice the model rate, resampled) against the JAX sharded ones."""
    f, jcfg, cfg, waves, _ = _fuzz()
    jrunner, runner = _jax_runner(k, "softmax"), _port_runner(k, "softmax")
    ref = np.asarray(J.make_embedder(jrunner, jcfg)(waves))
    got = P.make_embedder(runner, cfg, device="cpu")(waves)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    rate = 2 * cfg.sample_rate
    q = P.quantize_waveform_int16(np.random.default_rng(15).normal(
        0, 0.2, (B, rate)).astype(np.float32))
    classifier_for = P.make_classifier_cache(runner, cfg, input_dtype="int16", device="cpu")
    assert classifier_for(rate) is classifier_for(rate)
    ref = np.asarray(J.make_classifier_cache(jrunner, jcfg, input_dtype="int16")(rate)(q))
    np.testing.assert_allclose(classifier_for(rate)(q), ref, atol=SCORE_ATOL)
    as_tensor = P.make_fused_classifier(runner, cfg, as_numpy=False, device="cpu")(waves)
    assert isinstance(as_tensor, torch.Tensor) and as_tensor.device == CPU
    np.testing.assert_array_equal(as_tensor.numpy(),
                                  P.make_fused_classifier(runner, cfg, device="cpu")(waves))


INGRESS = ("float32", "int16", "ulaw", "resample48k")


@pytest.mark.parametrize("ingress", INGRESS)
@pytest.mark.parametrize("fused", [False, True])
def test_flagship_int8_over_a_mesh_equals_one_device(fused, ingress):
    """The flagship graph (entry unfused) and its entry-transpose fixture
    (the fused int8 entry) over two devices, at B=2, under each ingress:
    bit-equal to the same classifier without a mesh."""
    cfg = ModelConfig.load(FLAGSHIP_CONFIG)
    graph = tflite_import.TFLiteGraph(FLAGSHIP_TFLITE)
    graph = entry_transpose_fixture(graph) if fused else graph
    kw, rate = {}, cfg.sample_rate
    if ingress == "resample48k":
        kw, rate = {"input_sample_rate": 48000}, 48000
    wave = np.random.default_rng(16).normal(0, 0.2, (2, int(rate * cfg.chunk_duration)))
    wave = np.clip(wave, -0.99, 0.99).astype(np.float32)
    if ingress == "int16":
        kw["input_dtype"], wave = "int16", _raw_batch(17, 2, cfg.chunk_samples, [9000, 32768])[0]
    elif ingress == "ulaw":
        kw["input_dtype"], wave = "ulaw", P.quantize_waveform_ulaw(wave)
    scores = []
    for mesh in (["cpu", "cpu"], None):
        runner = TFLiteSimRunner(graph, device="cpu", mesh=mesh)
        classify = P.make_fused_classifier(runner, cfg, device="cpu", **kw)
        assert (classify.entry_quant is not None) == fused
        scores.append(classify(wave))
    assert scores[0].shape == (2, 100) and np.ptp(scores[0]) > 0
    np.testing.assert_array_equal(*scores)


def test_replicas_do_not_share_the_callers_model():
    """A bf16 runner over a mesh leaves the caller's model float32; each
    replica is its own bf16 copy."""
    model = _port_model("softmax")
    runner = TorchRunner(model, _fuzz()[2], dtype=torch.bfloat16, mesh=["cpu", "cpu"])
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert runner.replicas[CPU] is runner.model and runner.model is not model
