"""PyTorch port, evaluation: pooling (evaluation/pooling.py), the numpy
ranking metrics (evaluation/ranking.py), the metric helpers and
`evaluate` (evaluation/metrics.py) against the JAX package and
scikit-learn.

Tolerances, each stated where it is checked:
- pool_scores, lme_pooling: bit-equal to the JAX functions (the same numpy
  code); segment_pool (torch on the CPU) within 1e-6 of jax.ops' segment
  reductions, whose float32 sums run in another order;
- every ranking function within 1e-12 of scikit-learn, in float64, on
  random scores, tie-rich scores (multiples of 1/256, as the INT8 leg's
  dequantized LOGISTIC codes), columns with no positive or no negative,
  and one row;
- optimize_thresholds, metrics_at_thresholds, compute_det_curve equal to
  the JAX package's on its own pooled scores; bootstrap_ap_ci (seed 42,
  the same numpy draws) within 1e-12;
- evaluate, port on the CPU against the JAX package on seeded WAVs, float
  leg (the Flax weights carried across by models/convert.py): pooled
  scores within 1e-5 for every pooling, ingress and decode option. Random
  weights give near-tied scores, so the two runs' metrics are not
  compared; the port's metrics are held within 1e-12 of scikit-learn on
  the port's own pooled scores. INT8 leg on the committed flagship bundle:
  pooled scores at cosine >= 0.999 per file and within 2/256 (the JAX
  package feeds the executor from its XLA composition, the port from the
  kernel's plain version, which can move an entry code by one).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics as SK
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from birdnet_stm32_tpu.config import ModelConfig as JaxModelConfig
from birdnet_stm32_tpu.evaluation import metrics as JM
from birdnet_stm32_tpu.evaluation import pooling as JP
from birdnet_stm32_tpu.models.runners import FlaxRunner
from birdnet_stm32_tpu.models.runners import TFLiteSimRunner as JTFLiteSimRunner
from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.evaluation import metrics as PM
from birdnet_stm32_tpu_torch.evaluation import pooling as PP
from birdnet_stm32_tpu_torch.evaluation import ranking as R
from birdnet_stm32_tpu_torch.models.runners import TFLiteSimRunner, load_model_runner
from tests.int8_fixture import FLAGSHIP_TFLITE
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_fuzz_fixtures import bad_outputs
from tests.torch_train_fixtures import write_run_dir, write_wav_folder

warm_up()

CLASSES = ["a", "b", "c"]


def _scores(seed: int, shape=(7, 5)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# --- pooling -------------------------------------------------------------

@pytest.mark.parametrize("method", PP.POOLING_METHODS)
def test_pool_scores_matches_jax(method):
    s = _scores(0)
    np.testing.assert_array_equal(PP.pool_scores(s, method), JP.pool_scores(s, method))
    empty = np.zeros((0, 5), np.float32)
    np.testing.assert_array_equal(PP.pool_scores(empty, method), JP.pool_scores(empty, method))


def test_pool_scores_guards():
    with pytest.raises(ValueError, match="Unsupported"):
        PP.pool_scores(_scores(0), "median")
    with pytest.raises(ValueError, match="N_chunks"):
        PP.pool_scores(np.zeros(3, np.float32))
    assert PP.POOLING_METHODS == JP.POOLING_METHODS


@pytest.mark.parametrize("beta", [1.0, 10.0, 200.0])
def test_lme_pooling_matches_jax(beta):
    s = _scores(1, (9, 4))
    np.testing.assert_array_equal(PP.lme_pooling(s, beta), JP.lme_pooling(s, beta))
    # beta interpolates between the mean and the max.
    got = PP.lme_pooling(s, beta)
    assert np.all(got <= s.max(0) + 1e-6) and np.all(got >= s.mean(0) - 1e-6)


@pytest.mark.parametrize("method", PP.POOLING_METHODS)
def test_segment_pool_matches_jax(method):
    """Files 1 and 4 have no chunk (zeros, as in JAX); the rest equal
    jax.ops' segment reductions within 1e-6 and pool_scores per file."""
    s = _scores(2, (11, 6))
    ids = np.array([0, 2, 2, 3, 0, 5, 5, 5, 3, 2, 0], np.int32)
    got = PP.segment_pool(torch.from_numpy(s), torch.from_numpy(ids), 6, method, beta=10.0)
    ref = np.asarray(JP.segment_pool(jnp.asarray(s), jnp.asarray(ids), 6, method, beta=10.0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert not got[[1, 4]].any()
    for f in (0, 2, 3, 5):
        np.testing.assert_allclose(got[f].numpy(), PP.pool_scores(s[ids == f], method),
                                   rtol=0, atol=1e-6)


def test_segment_pool_unknown_method():
    with pytest.raises(ValueError, match="Unsupported"):
        PP.segment_pool(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long), 1, "median")


# --- ranking -------------------------------------------------------------

def _ranking_inputs(kind: str, seed: int = 0):
    """(y_true [N, C] float32, y_score [N, C] float32) of one kind."""
    rng = np.random.default_rng(seed)
    n, c = (1, 6) if kind == "one_row" else (40, 6)
    y = (rng.random((n, c)) < 0.3).astype(np.float32)
    if kind == "ties":
        s = (rng.integers(0, 257, (n, c)) / 256.0).astype(np.float32)
    else:
        s = rng.random((n, c)).astype(np.float32)
    if kind == "no_positive":
        y[:, :3] = 0.0
    if kind == "all_positive":
        y[:, :3] = 1.0
    if kind == "one_row":
        y[0] = [1, 0, 1, 0, 0, 1]
    return y, s


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, equal_nan=True)


KINDS = ["random", "ties", "no_positive", "all_positive", "one_row"]


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("kind", KINDS)
def test_roc_auc_matches_sklearn(kind):
    y, s = _ranking_inputs(kind)
    for c in range(y.shape[1]):
        _close(R.roc_auc_score(y[:, c], s[:, c]), SK.roc_auc_score(y[:, c], s[:, c]))
    _close(R.roc_auc_score(y, s, average="micro"), SK.roc_auc_score(y, s, average="micro"))


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("kind", KINDS)
def test_average_precision_matches_sklearn(kind):
    y, s = _ranking_inputs(kind)
    for c in range(y.shape[1]):
        _close(R.average_precision_score(y[:, c], s[:, c]),
               SK.average_precision_score(y[:, c], s[:, c]))
    _close(R.average_precision_score(y, s, average="micro"),
           SK.average_precision_score(y, s, average="micro"))


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("kind", KINDS)
def test_curves_match_sklearn(kind):
    y, s = _ranking_inputs(kind)
    for c in range(y.shape[1]):
        got, ref = R.precision_recall_curve(y[:, c], s[:, c]), SK.precision_recall_curve(y[:, c], s[:, c])
        for g, r in zip(got, ref):
            _close(g, r)
        assert got[2].dtype == ref[2].dtype
        for g, r in zip(R.roc_curve(y[:, c], s[:, c]), SK.roc_curve(y[:, c], s[:, c])):
            _close(g, r)
    got, ref = R.precision_recall_curve(y.ravel(), s.ravel()), SK.precision_recall_curve(y.ravel(), s.ravel())
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("kind", KINDS)
def test_confusion_matrix_matches_sklearn(kind):
    """The top-1 confusion of reporting.py, with the sub-threshold -1 bucket."""
    y, s = _ranking_inputs(kind)
    true_idx = np.argmax(y, axis=1)
    pred = np.argmax(s, axis=1)
    pred[np.max(s, axis=1) < 0.6] = -1
    labels = list(range(y.shape[1])) + [-1]
    got, ref = R.confusion_matrix(true_idx, pred, labels), SK.confusion_matrix(true_idx, pred, labels=labels)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype


def test_auc_direction_and_guards():
    assert R.auc([0, 0.5, 1], [0, 1, 1]) == SK.auc([0, 0.5, 1], [0, 1, 1])
    assert R.auc([1, 0.5, 0], [1, 1, 0]) == SK.auc([1, 0.5, 0], [1, 1, 0])
    for x in ([0.0], [0, 1, 0.5]):
        with pytest.raises(ValueError):
            R.auc(x, np.zeros(len(x)))
    for average in (None, "macro"):  # a label matrix takes 'micro' only
        with pytest.raises(ValueError, match="average"):
            R.average_precision_score(np.eye(3), np.eye(3), average=average)


@pytest.mark.filterwarnings("ignore")
@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 30), levels=st.sampled_from([2, 5, 257]), seed=st.integers(0, 2**31),
       p=st.floats(0.0, 1.0))
def test_ranking_matches_sklearn_hypothesis(n, levels, seed, p):
    """Binary AP, ROC-AUC and the PR curve within 1e-12 on scores drawn
    from `levels` distinct values (257: the 1/256 grid)."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < p).astype(np.float32)
    s = (rng.integers(0, levels, n) / (levels - 1)).astype(np.float32)
    _close(R.average_precision_score(y, s), SK.average_precision_score(y, s))
    _close(R.roc_auc_score(y, s), SK.roc_auc_score(y, s))
    for g, r in zip(R.precision_recall_curve(y, s), SK.precision_recall_curve(y, s)):
        _close(g, r)


# --- evaluate, port against JAX -------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded WAVs at the tiny config's 4 kHz (three classes and a noise
    folder, 1.5-3.5 s each) and a run directory of the port's format with
    Flax weights; the JAX runner holds the same weights."""
    root = tmp_path_factory.mktemp("evaluate")
    write_wav_folder(root / "data", files_per_class=3)
    jmodel, variables, jcfg, cfg = write_run_dir(root / "run", seed=0)
    files = sorted(str(p) for p in (root / "data").rglob("*.wav"))
    return files, root / "run", FlaxRunner(jmodel, variables, jcfg), jcfg, cfg


@pytest.fixture(scope="module")
def jax_evaluate(data):
    """The JAX evaluate of `data` with some keywords, run once per set."""
    runs = {}

    def run(**kw):
        key = tuple(sorted(kw.items()))
        if key not in runs:
            files, _, jrunner, jcfg, _ = data
            runs[key] = JM.evaluate(jrunner, files, CLASSES, jcfg, batch_size=8, **kw)
        return runs[key]

    return run


def _port_evaluate(data, **kw):
    files, run_dir, _, _, cfg = data
    return PM.evaluate(load_model_runner(run_dir, device="cpu"), files, CLASSES, cfg,
                       batch_size=8, device="cpu", **kw)


def _hold_metrics_to_sklearn(metrics, y_true, y_scores):
    """The port's metrics against scikit-learn on the port's pooled scores."""
    _close(metrics["roc-auc"], SK.roc_auc_score(y_true, y_scores, average="micro"))
    aps = [SK.average_precision_score(y_true[:, c], y_scores[:, c]) for c in range(y_true.shape[1])]
    _close(metrics["ap_per_class"], aps)
    _close(metrics["cmAP"], np.mean([a for a in aps if not math.isnan(a)]))
    _close(metrics["mAP"], SK.average_precision_score(y_true, y_scores, average="micro"))
    pred = (y_scores >= 0.5).astype(np.float32)
    _close([metrics["precision"], metrics["recall"]],
           [SK.precision_score(y_true, pred, average="micro", zero_division=0),
            SK.recall_score(y_true, pred, average="micro", zero_division=0)], tol=1e-9)


CASES = {"average": dict(pooling="average"), "max": dict(pooling="max"),
         "lme": dict(pooling="lme", mep_beta=10.0), "int16_io": dict(int16_io=True),
         "ulaw_io": dict(ulaw_io=True), "max_duration": dict(max_duration=2.0)}


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_float_leg_matches_jax(data, jax_evaluate, case):
    kw = CASES[case]
    metrics, per_file, y_true, y_scores = _port_evaluate(data, **kw)
    jm, jper_file, jy_true, jy_scores = jax_evaluate(**kw)
    assert [(r["file"], r["label"]) for r in per_file] == [(r["file"], r["label"]) for r in jper_file]
    assert metrics["total_chunks"] == jm["total_chunks"] > 0
    np.testing.assert_array_equal(y_true, jy_true)
    np.testing.assert_allclose(y_scores, jy_scores, rtol=0, atol=1e-5)  # the float leg's gate
    _hold_metrics_to_sklearn(metrics, y_true, y_scores)


def test_evaluate_decode_workers_equal_serial(data):
    serial = _port_evaluate(data)
    threaded = _port_evaluate(data, decode_workers=2)
    assert serial[1] == threaded[1]
    np.testing.assert_array_equal(serial[3], threaded[3])
    assert serial[0]["total_chunks"] == threaded[0]["total_chunks"]


def test_evaluate_latency_memory_and_guards(data):
    metrics, *_ = _port_evaluate(data, measure_latency=True, profile_memory=True)
    for k in ("latency_mean_ms", "latency_median_ms", "latency_p95_ms", "latency_p99_ms",
              "blocking_read_floor_ms", "latency_mean_device_est_ms", "peak_rss_mb",
              "rss_delta_mb"):
        assert np.isfinite(metrics[k]) and metrics[k] >= 0, k
    assert "latency_note" in metrics
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port_evaluate(data, int16_io=True, ulaw_io=True)
    files, run_dir, *_ = data
    with pytest.raises(RuntimeError, match="No valid test samples"):
        PM.evaluate(load_model_runner(run_dir, device="cpu"), files, ["zz"],
                    data[4], device="cpu")


# The INT8 leg runs the committed flagship bundle (a trained 100-class
# graph at 22.05 kHz; its pooled scores vary, from 0.07 to 0.98 per file on
# these WAVs) over three of its classes. The committed fuzz graphs would not
# do: graph 3 scores 0.5 for every class on any input.
FLAGSHIP_CLASSES = 3


@pytest.fixture(scope="module")
def int8_leg(tmp_path_factory):
    """The port's and the JAX package's evaluate of the flagship bundle on
    WAVs of three of its classes (and noise) at its rate."""
    cfg_dict = json.loads((FLAGSHIP_TFLITE.parent / "model_config.json").read_text())
    classes = cfg_dict["class_names"]
    root = write_wav_folder(tmp_path_factory.mktemp("flagship") / "data", sample_rate=22050,
                            classes=classes[:FLAGSHIP_CLASSES], files_per_class=2, seed=3)
    files = sorted(str(p) for p in root.rglob("*.wav"))
    port = PM.evaluate(TFLiteSimRunner(FLAGSHIP_TFLITE, device="cpu"), files, classes,
                       ModelConfig.from_dict(cfg_dict), batch_size=8, device="cpu")
    ref = JM.evaluate(JTFLiteSimRunner(FLAGSHIP_TFLITE), files, classes,
                      JaxModelConfig.from_dict(cfg_dict), batch_size=8)
    return port, ref


def _int8_scores_match(y_scores, jy_scores) -> bool:
    """The INT8 leg's gate: within 2/256 and per-file cosine >= 0.999."""
    cos = (y_scores * jy_scores).sum(1) / (np.linalg.norm(y_scores, axis=1)
                                           * np.linalg.norm(jy_scores, axis=1))
    return bool(np.abs(y_scores - jy_scores).max() <= 2 / 256 and cos.min() >= 0.999)


@pytest.mark.filterwarnings("ignore")
def test_evaluate_int8_leg_matches_jax(int8_leg):
    """The INT8 leg on the flagship bundle; 97 of its classes have no file."""
    (metrics, _, y_true, y_scores), (jm, _, jy_true, jy_scores) = int8_leg
    np.testing.assert_array_equal(y_true, jy_true)
    assert metrics["total_chunks"] == jm["total_chunks"]
    assert np.ptp(jy_scores, axis=1).min() > 4 / 256  # scores that vary
    assert _int8_scores_match(y_scores, jy_scores)
    _hold_metrics_to_sklearn(metrics, y_true, y_scores)
    assert metrics["ap_per_class"][FLAGSHIP_CLASSES] == 0.0  # no positive: AP 0.0


@pytest.mark.parametrize("variant", ["constant", "shuffled"])
def test_evaluate_int8_gate_bites(int8_leg, variant):
    """The gate above fails on a constant and on a class-shuffled score
    vector in place of the port's."""
    jy_scores = int8_leg[1][3]
    assert not _int8_scores_match(bad_outputs(jy_scores)[variant], jy_scores)


# --- the metric helpers on the JAX package's pooled scores ----------------

def _jax_pooled(jax_evaluate, tie_rich: bool):
    _, _, y_true, y_scores = jax_evaluate(pooling="average")
    if tie_rich:  # the INT8 leg's score grid
        y_scores = (np.round(y_scores * 16) / 16).astype(np.float32)
    return y_true, y_scores


@pytest.mark.parametrize("tie_rich", [False, True], ids=["pooled", "tie_rich"])
def test_threshold_helpers_equal_jax(jax_evaluate, tie_rich):
    y_true, y_scores = _jax_pooled(jax_evaluate, tie_rich)
    th = PM.optimize_thresholds(y_true, y_scores, CLASSES)
    assert th == JM.optimize_thresholds(y_true, y_scores, CLASSES)
    th["b"] = 0.25
    del th["c"]  # a missing class uses 0.5
    assert PM.metrics_at_thresholds(y_true, y_scores, th, CLASSES) == \
        JM.metrics_at_thresholds(y_true, y_scores, th, CLASSES)
    y0 = y_true.copy()
    y0[:, 2] = 0
    assert PM.optimize_thresholds(y0, y_scores, CLASSES)["c"] == 0.5


@pytest.mark.parametrize("tie_rich", [False, True], ids=["pooled", "tie_rich"])
def test_bootstrap_ap_ci_equals_jax(jax_evaluate, tie_rich):
    y_true, y_scores = _jax_pooled(jax_evaluate, tie_rich)
    y_true = np.concatenate([y_true, np.ones((y_true.shape[0], 1), np.float32)], axis=1)
    y_scores = np.concatenate([y_scores, y_scores[:, :1]], axis=1)  # an all-positive class
    classes = [*CLASSES, "all"]
    got = PM.bootstrap_ap_ci(y_true, y_scores, classes, n_bootstrap=200, seed=42)
    ref = JM.bootstrap_ap_ci(y_true, y_scores, classes, n_bootstrap=200, seed=42)
    assert [(g["class"], g["n_positive"], g["n_total"]) for g in got] == \
        [(r["class"], r["n_positive"], r["n_total"]) for r in ref]
    for g, r in zip(got, ref):
        _close([g["ap"], g["ci_lower"], g["ci_upper"]], [r["ap"], r["ci_lower"], r["ci_upper"]])
    assert got[-1]["ci_lower"] == got[-1]["ci_upper"] == got[-1]["ap"]


@pytest.mark.parametrize("tie_rich", [False, True], ids=["pooled", "tie_rich"])
def test_det_curve_equals_jax(jax_evaluate, tie_rich):
    y_true, y_scores = _jax_pooled(jax_evaluate, tie_rich)
    for g, r in zip(PM.compute_det_curve(y_true, y_scores), JM.compute_det_curve(y_true, y_scores)):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(PM.compute_det_curve(np.zeros_like(y_true), y_scores),
                    JM.compute_det_curve(np.zeros_like(y_true), y_scores)):
        np.testing.assert_array_equal(g, r)
