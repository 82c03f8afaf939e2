"""Quantization validation metrics: cosine, Pearson, and the per-sample
sweep of two runners (port of quant/validate.py, numpy only).

Edge cases as the reference's conversion/validate.py: two near-zero vectors
are perfectly similar (1.0), one near-zero and one not are dissimilar
(0.0), and a constant side gives Pearson 1.0.
"""

from __future__ import annotations

import numpy as np


def cosine_similarity(a: np.ndarray, b: np.ndarray, eps: float = 1e-8) -> float:
    """Cosine similarity in float64; both norms below eps -> 1.0, one -> 0.0."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < eps and nb < eps:
        return 1.0
    if na < eps or nb < eps:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def pearson_correlation(a: np.ndarray, b: np.ndarray, eps: float = 1e-12) -> float:
    """Pearson r in float64; when the product of the centered norms is below
    eps (either side constant) it is 1.0, the reference's zero-variance
    guard."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a = a - a.mean()
    b = b - b.mean()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom < eps:
        return 1.0
    return float(np.dot(a, b) / denom)


def validate_runners(runner_a, runner_b, inputs: np.ndarray, batch_size: int = 32) -> dict:
    """Compare two runners sample by sample.

    Args:
        runner_a: Reference runner (the float model).
        runner_b: Candidate runner (the INT8 executor).
        inputs: [N, ...] model inputs.
        batch_size: Inference batch size.

    Returns:
        Mean / std / min / max of the per-sample cosine, and the mean
        Pearson r, MSE and MAE; NaNs and n_samples 0 for no input.
    """
    if len(inputs) == 0:
        return {"cosine_mean": float("nan"), "cosine_std": float("nan"),
                "cosine_min": float("nan"), "cosine_max": float("nan"),
                "pearson_mean": float("nan"), "mse_mean": float("nan"),
                "mae_mean": float("nan"), "n_samples": 0}
    cosines, pearsons, mses, maes = [], [], [], []
    for i in range(0, len(inputs), batch_size):
        chunk = inputs[i : i + batch_size]
        ya = np.asarray(runner_a.predict(chunk))
        yb = np.asarray(runner_b.predict(chunk))
        for j in range(chunk.shape[0]):
            cosines.append(cosine_similarity(ya[j], yb[j]))
            pearsons.append(pearson_correlation(ya[j], yb[j]))
            mses.append(float(np.mean((ya[j] - yb[j]) ** 2)))
            maes.append(float(np.mean(np.abs(ya[j] - yb[j]))))
    c = np.asarray(cosines)
    return {
        "cosine_mean": float(c.mean()),
        "cosine_std": float(c.std()),
        "cosine_min": float(c.min()),
        "cosine_max": float(c.max()),
        "pearson_mean": float(np.mean(pearsons)),
        "mse_mean": float(np.mean(mses)),
        "mae_mean": float(np.mean(maes)),
        "n_samples": len(cosines),
    }
