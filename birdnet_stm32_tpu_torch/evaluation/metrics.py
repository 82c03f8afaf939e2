"""Evaluation: batched chunk inference, pooling and classification metrics
(port of evaluation/metrics.py).

Every file's chunks join one flat batch stream, padded to a fixed batch
and classified by the fused ingress + frontend + model dispatch
(models/serving.py) on the runner's device; chunk scores pool per file on
the host (pooling.py). The metrics are the JAX package's: micro ROC-AUC,
precision / recall / F1 at 0.5 (micro counts), per-class AP, cmAP (the
mean of the valid APs), micro mAP, per-class F1-optimal thresholds,
bootstrap AP intervals and the DET curve. The JAX package reads them from
scikit-learn; the port computes them with evaluation/ranking.py, which
equals scikit-learn.
"""

from __future__ import annotations

import math
import resource
import time
from pathlib import Path

import numpy as np

from birdnet_stm32_tpu_torch.audio.io import load_audio_file
from birdnet_stm32_tpu_torch.evaluation.pooling import pool_scores
from birdnet_stm32_tpu_torch.evaluation.ranking import (
    average_precision_score,
    precision_recall_curve,
    roc_auc_score,
)


def chunks_for_file(path: str, cfg, overlap: float = 0.0, max_duration: float | None = 60.0,
                    sample_rate: int | None = None, cache_dir: str | None = None) -> np.ndarray:
    """[n_chunks, T] waveform chunks for one file.

    `sample_rate` overrides cfg.sample_rate for device-resample serving:
    chunks come back at the file's native rate (T = chunk_duration * rate)
    and the classifier resamples on the device (ops/resample.py). cache_dir
    routes the decode through the decoded-waveform cache.
    """
    return load_audio_file(path, sample_rate=sample_rate or cfg.sample_rate,
                           max_duration=max_duration, chunk_duration=cfg.chunk_duration,
                           chunk_overlap=overlap, random_offset=False, cache_dir=cache_dir)


def _micro_prf(y_true: np.ndarray, y_pred: np.ndarray) -> tuple[float, float, float]:
    """Micro precision, recall and F1 of 0/1 predictions."""
    tp = float(np.sum(y_true * y_pred))
    fp = float(np.sum((1 - y_true) * y_pred))
    fn = float(np.sum(y_true * (1 - y_pred)))
    precision = tp / (tp + fp + 1e-12)
    recall = tp / (tp + fn + 1e-12)
    f1 = float(2 * precision * recall / (precision + recall)) if precision + recall > 0 else 0.0
    return precision, recall, f1


def blocking_read_floor_ms(device) -> float:
    """Median ms of five tiny ops on `device`, each read back with .item():
    the per-batch cost of one blocking host read, which every timed batch
    of evaluate(measure_latency=True) pays."""
    import torch

    x = torch.zeros((), device=device)
    (x + 1.0).item()  # first-call set-up
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        (x + 1.0).item()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times))


def evaluate(
    runner,
    files: list[str],
    classes: list[str],
    cfg,
    pooling: str = "average",
    batch_size: int = 64,
    overlap: float = 0.0,
    mep_beta: float = 10.0,
    measure_latency: bool = False,
    profile_memory: bool = False,
    label_fn=None,
    decode_workers: int = 0,
    max_duration: float = 60.0,
    cache_dir: str | None = None,
    int16_io: bool = False,
    ulaw_io: bool = False,
    device="cuda",
) -> tuple[dict, list[dict], np.ndarray, np.ndarray]:
    """Per-chunk inference -> pooled file scores -> metrics.

    Args:
        runner: a runner of models/runners.py on `device` (or the host
            interpreter runner).
        files: Audio file paths (class = parent folder name by default).
        classes: Ordered class names.
        cfg: Model config (drives chunking + frontend).
        pooling: 'avg' | 'max' | 'lme' (and pooling.POOLING_METHODS' aliases).
        batch_size: Chunk batch size; every batch is padded to it.
        overlap: Chunk overlap seconds.
        mep_beta: LME temperature.
        measure_latency: Record per-chunk latency stats (over the padded
            rows; one warm-up call first, outside the stats).
        profile_memory: Record peak-RSS stats.
        label_fn: Optional path -> class-name override.
        decode_workers: >0 decodes files ahead on that many threads
            (batches and results are unchanged).
        max_duration: Per-file decode cap in seconds.
        cache_dir: decoded-waveform cache directory.
        int16_io: Ship waveforms as int16 codes + scale column (raw PCM
            codes, bit-exact, for mono PCM16 WAVs at the model rate;
            requantized, one LSB, otherwise).
        ulaw_io: Ship waveforms as int8 mu-law codes (not bit-exact).
        device: Where ingress, frontend and model run (default CUDA).

    Returns:
        (metrics dict, per_file list, y_true [N, C], y_scores [N, C]).
    """
    from birdnet_stm32_tpu_torch.models.serving import (
        chunks_for_classify_int16,
        make_fused_classifier,
        quantize_waveform_ulaw,
    )

    if int16_io and ulaw_io:
        raise ValueError("int16_io and ulaw_io are mutually exclusive")
    label_fn = label_fn or (lambda p: Path(p).parent.name)
    num_classes = len(classes)
    class_idx = {c: i for i, c in enumerate(classes)}

    rss_before_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss if profile_memory else 0
    latencies: list[float] = []
    total_chunks = 0

    y_true, y_scores, per_file = [], [], []
    pending_chunks: list[np.ndarray] = []
    pending_meta: list[int] = []  # file index per chunk
    file_records: list[tuple[str, str, np.ndarray]] = []  # (path, label, target)
    chunk_scores_per_file: dict[int, list[np.ndarray]] = {}

    classify = make_fused_classifier(
        runner, cfg, input_dtype="int16" if int16_io else ("ulaw" if ulaw_io else None),
        device=device)
    if int16_io:
        def _chunks(path):
            return chunks_for_classify_int16(path, cfg, overlap, max_duration=max_duration,
                                             cache_dir=cache_dir)
    elif ulaw_io:
        def _chunks(path):
            return quantize_waveform_ulaw(chunks_for_file(
                path, cfg, overlap, max_duration=max_duration, cache_dir=cache_dir))
    else:
        def _chunks(path):
            return chunks_for_file(path, cfg, overlap, max_duration=max_duration,
                                   cache_dir=cache_dir)
    warmed = False

    def flush(force=False):
        nonlocal warmed, total_chunks
        while pending_chunks and (force or len(pending_chunks) >= batch_size):
            take = pending_chunks[:batch_size]
            meta = pending_meta[:batch_size]
            del pending_chunks[:batch_size], pending_meta[:batch_size]
            wave = np.stack(take)
            # Pad to the fixed batch size: one executor and one shape for all.
            if wave.shape[0] < batch_size:
                wave = np.pad(wave, ((0, batch_size - wave.shape[0]), (0, 0)))
            if measure_latency and not warmed:
                classify(wave)  # keep first-call set-up out of the latency stats
            warmed = True
            t0 = time.perf_counter()
            scores = classify(wave)[: len(take)]
            if measure_latency:
                # Per row the device computed (the padded batch): a 1-chunk
                # tail would otherwise read batch_size times too slow.
                per_chunk_ms = (time.perf_counter() - t0) * 1000.0 / wave.shape[0]
                latencies.extend([per_chunk_ms] * len(take))
            total_chunks += len(take)
            for fi, s in zip(meta, scores):
                chunk_scores_per_file.setdefault(fi, []).append(s)

    labeled = [(p, label_fn(p)) for p in files]
    labeled = [(p, lb) for p, lb in labeled if lb in class_idx]

    def consume(path, label, chunks):
        if chunks.shape[0] == 0:
            return
        target = np.zeros(num_classes, np.float32)
        target[class_idx[label]] = 1.0
        fi = len(file_records)
        file_records.append((path, label, target))
        for c in chunks:
            pending_chunks.append(c)
            pending_meta.append(fi)
        flush()

    if decode_workers > 0:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=decode_workers) as ex:
            # A bounded decode-ahead window keeps large test sets in RAM.
            window = max(2 * decode_workers, 4)
            futs = deque((p, lb, ex.submit(_chunks, p)) for p, lb in labeled[:window])
            nxt = window
            while futs:
                path, label, fut = futs.popleft()
                if nxt < len(labeled):
                    p, lb = labeled[nxt]
                    futs.append((p, lb, ex.submit(_chunks, p)))
                    nxt += 1
                consume(path, label, fut.result())
    else:
        for path, label in labeled:
            consume(path, label, _chunks(path))
    flush(force=True)

    for fi, (path, label, target) in enumerate(file_records):
        scores = np.stack(chunk_scores_per_file.get(fi, [np.zeros(num_classes, np.float32)]))
        pooled = pool_scores(scores, method=pooling, beta=mep_beta)
        y_true.append(target)
        y_scores.append(pooled)
        per_file.append({"file": path, "label": label, "scores": pooled.tolist()})

    if not y_true:
        raise RuntimeError("No valid test samples found for the provided class set.")
    y_true_arr = np.asarray(y_true, np.float32)
    y_scores_arr = np.asarray(y_scores, np.float32)

    metrics: dict = {"roc-auc": float(roc_auc_score(y_true_arr, y_scores_arr, average="micro"))}
    metrics["precision"], metrics["recall"], metrics["f1"] = _micro_prf(
        y_true_arr, (y_scores_arr >= 0.5).astype(np.float32))

    ap_per_class = [average_precision_score(y_true_arr[:, ci], y_scores_arr[:, ci])
                    for ci in range(num_classes)]
    valid = [a for a in ap_per_class if not math.isnan(a)]
    metrics["ap_per_class"] = ap_per_class
    metrics["cmAP"] = float(np.mean(valid)) if valid else float("nan")
    metrics["mAP"] = float(average_precision_score(y_true_arr, y_scores_arr, average="micro"))

    metrics["total_chunks"] = total_chunks
    if measure_latency and latencies:
        lat = np.asarray(latencies)
        metrics["latency_mean_ms"] = float(lat.mean())
        metrics["latency_median_ms"] = float(np.median(lat))
        metrics["latency_p95_ms"] = float(np.percentile(lat, 95))
        metrics["latency_p99_ms"] = float(np.percentile(lat, 99))
        # Every timed batch ends in one blocking read of the scores: report
        # that floor and a latency estimate without it.
        floor_ms = blocking_read_floor_ms(getattr(runner, "device", device))
        metrics["blocking_read_floor_ms"] = floor_ms
        metrics["latency_mean_device_est_ms"] = max(
            0.0, metrics["latency_mean_ms"] - floor_ms / batch_size)
        metrics["latency_note"] = (
            f"per-chunk stats include a {floor_ms:.1f} ms blocking "
            f"host-read floor per {batch_size}-chunk batch; "
            "latency_mean_device_est_ms subtracts it. For throughput use "
            "benchmark --pipeline.")
    if profile_memory:
        rss_after_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        metrics["peak_rss_mb"] = round(rss_after_kb / 1024, 1)
        metrics["rss_delta_mb"] = round((rss_after_kb - rss_before_kb) / 1024, 1)

    return metrics, per_file, y_true_arr, y_scores_arr


def optimize_thresholds(y_true: np.ndarray, y_scores: np.ndarray,
                        classes: list[str]) -> dict[str, float]:
    """Per-class F1-optimal thresholds from the PR curve (0.5 for a class
    with no positive)."""
    optimal: dict[str, float] = {}
    for ci, name in enumerate(classes):
        col_true, col_scores = y_true[:, ci], y_scores[:, ci]
        if col_true.sum() == 0:
            optimal[name] = 0.5
            continue
        prec, rec, thresholds = precision_recall_curve(col_true, col_scores)
        f1 = 2 * prec[:-1] * rec[:-1] / (prec[:-1] + rec[:-1] + 1e-12)
        optimal[name] = float(thresholds[int(np.argmax(f1))])
    return optimal


def metrics_at_thresholds(y_true: np.ndarray, y_scores: np.ndarray,
                          thresholds: dict[str, float], classes: list[str]) -> dict[str, float]:
    """Micro precision / recall / F1 at per-class thresholds (0.5 for a
    class the dict lacks), computed as evaluate()'s row at 0.5."""
    thr = np.asarray([thresholds.get(c, 0.5) for c in classes], np.float32)[None, :]
    precision, recall, f1 = _micro_prf(y_true, (y_scores >= thr).astype(np.float32))
    return {"precision": precision, "recall": recall, "f1": f1}


def bootstrap_ap_ci(y_true: np.ndarray, y_scores: np.ndarray, classes: list[str],
                    n_bootstrap: int = 1000, confidence: float = 0.95,
                    seed: int = 42) -> list[dict]:
    """Per-class AP with bootstrap intervals. One numpy default_rng(seed)
    draws every class's [n_bootstrap, n] resample indices in class order
    (the JAX package's draws); resamples with one class only are skipped,
    and a class with no positive or no negative gets its AP as both
    bounds."""
    rng = np.random.default_rng(seed)
    n = y_true.shape[0]
    alpha = (1 - confidence) / 2
    results = []
    for ci, name in enumerate(classes):
        col_true, col_scores = y_true[:, ci], y_scores[:, ci]
        n_pos = int(col_true.sum())
        ap = float(average_precision_score(col_true, col_scores))
        if n_pos == 0 or n_pos == n:
            results.append({"class": name, "ap": ap, "ci_lower": ap, "ci_upper": ap,
                            "n_positive": n_pos, "n_total": n})
            continue
        idx = rng.integers(0, n, size=(n_bootstrap, n))
        boot = []
        for row in idx:
            bt = col_true[row]
            s = bt.sum()
            if s == 0 or s == len(bt):
                continue
            boot.append(float(average_precision_score(bt, col_scores[row])))
        lo = float(np.percentile(boot, 100 * alpha)) if boot else ap
        hi = float(np.percentile(boot, 100 * (1 - alpha))) if boot else ap
        results.append({"class": name, "ap": ap, "ci_lower": lo, "ci_upper": hi,
                        "n_positive": n_pos, "n_total": n})
    return results


def compute_det_curve(y_true: np.ndarray, y_scores: np.ndarray):
    """DET curve over the flattened labels: (FAR, FRR, thresholds) at each
    distinct score, highest first, by cumulative sums."""
    y_t = y_true.ravel().astype(np.float64)
    y_s = y_scores.ravel().astype(np.float64)
    total_pos = y_t.sum()
    total_neg = len(y_t) - total_pos
    if total_pos == 0 or total_neg == 0:
        return np.array([0.0]), np.array([0.0]), np.array([0.5])

    order = np.argsort(-y_s)
    sorted_scores = y_s[order]
    sorted_true = y_t[order]
    cum_tp = np.cumsum(sorted_true)
    cum_fp = np.cumsum(1 - sorted_true)
    # The last index of each distinct threshold, in descending order.
    uniq_mask = np.append(sorted_scores[1:] != sorted_scores[:-1], True)
    thr = sorted_scores[uniq_mask]
    tp = cum_tp[uniq_mask]
    fp = cum_fp[uniq_mask]
    return fp / total_neg, (total_pos - tp) / total_pos, thr
