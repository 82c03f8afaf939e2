"""ASCII plots, CSV / JSON export and a self-contained HTML report (port
of evaluation/reporting.py).

The columns, the JSON schema and the ASCII layouts are the JAX package's,
so tools read either package's reports. The PR curve and the confusion
matrix come from evaluation/ranking.py in place of scikit-learn.
Matplotlib is imported only inside the plotting functions, which do
nothing without it (the port's card machine has none).
"""

from __future__ import annotations

import base64
import io
import json
from pathlib import Path

import numpy as np

from birdnet_stm32_tpu_torch.evaluation.ranking import confusion_matrix, precision_recall_curve


def print_ascii_histogram(scores: np.ndarray, bins: int = 10, width: int = 40) -> None:
    """ASCII histogram of scores in [0, 1]."""
    hist, edges = np.histogram(scores, bins=bins, range=(0, 1))
    peak = hist.max()
    for i in range(bins):
        bar = "#" * int(width * hist[i] / peak) if peak > 0 else ""
        print(f"{edges[i]:4.2f} - {edges[i + 1]:4.2f} | {bar} ({hist[i]})")


def print_ascii_pr_curve(y_true: np.ndarray, y_scores: np.ndarray, bins: int = 10, width: int = 40) -> None:
    """ASCII PR curve: max recall per precision bin."""
    prec, rec, _ = precision_recall_curve(y_true.ravel(), y_scores.ravel())
    prec, rec = prec[:-1], rec[:-1]
    edges = np.linspace(1.0, 0.0, bins + 1)
    print("\nASCII Precision-Recall Curve (precision down, recall right):")
    for i in range(bins):
        mask = (prec >= edges[i + 1]) & (prec <= edges[i])
        max_recall = float(np.max(rec[mask])) if np.any(mask) else 0.0
        print(f"{edges[i]:4.1f} | {'#' * int(width * max_recall)} ({max_recall:4.2f})")


def print_ascii_det_curve(far: np.ndarray, frr: np.ndarray, bins: int = 10, width: int = 40) -> None:
    """ASCII DET curve: min FAR per FRR bin."""
    print("\nASCII DET Curve (FRR down, FAR right):")
    edges = np.linspace(0.0, 1.0, bins + 1)
    for i in range(bins):
        mask = (frr >= edges[i]) & (frr < edges[i + 1])
        min_far = float(np.min(far[mask])) if np.any(mask) else 1.0
        print(f"FRR {edges[i]:4.2f}-{edges[i + 1]:4.2f} | {'#' * int(width * min_far)} (FAR={min_far:4.3f})")


def _top1_confusion(y_true, y_scores, num_classes, threshold):
    true_idx = np.argmax(y_true, axis=1)
    pred_idx = np.argmax(y_scores, axis=1).copy()
    pred_idx[np.max(y_scores, axis=1) < threshold] = -1
    # Last column = the sub-threshold 'none' bucket (label -1); without it
    # those samples would be dropped and the accuracy inflated.
    return confusion_matrix(true_idx, pred_idx, labels=list(range(num_classes)) + [-1])


def print_confusion_matrix(y_true, y_scores, classes, threshold: float = 0.5) -> None:
    """ASCII top-1 confusion matrix with a sub-threshold 'none' bucket."""
    cm = _top1_confusion(y_true, y_scores, len(classes), threshold)
    w = min(12, max(len(c) for c in classes)) if classes else 6
    short = [c[:w] for c in classes]
    print("\nConfusion Matrix (rows=true, cols=predicted; last col = below threshold):")
    print(" " * (w + 1) + " ".join(f"{n:>{w}}" for n in short + ["none"]))
    for i, row in enumerate(cm[: len(classes)]):
        print(f"{short[i]:>{w}} " + " ".join(f"{v:>{w}}" for v in row))
    correct, total = np.trace(cm[: len(classes), : len(classes)]), cm.sum()
    print(f"\nAccuracy: {correct}/{total} ({100 * correct / max(total, 1):.1f}%)")


def save_predictions_csv(per_file: list[dict], classes: list[str], out_path: str | Path) -> None:
    """CSV: file, label, top1_label, top1_score, <per-class scores>."""
    import csv

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)  # quotes paths/labels containing commas
        writer.writerow(["file", "label", "top1_label", "top1_score"] + list(classes))
        for row in per_file:
            scores = np.asarray(row["scores"])
            top1 = int(np.argmax(scores))
            writer.writerow([row["file"], row["label"], classes[top1],
                             f"{scores[top1]:.3f}"] + [f"{s:.3f}" for s in scores])


def save_species_report_csv(species_data: list[dict], out_path: str | Path) -> None:
    """Per-species AP + CI CSV, sorted by AP descending."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        f.write("class,ap,ci_lower,ci_upper,n_positive,n_total\n")
        for r in sorted(species_data, key=lambda r: r["ap"], reverse=True):
            f.write(f"{r['class']},{r['ap']:.6f},{r['ci_lower']:.6f},{r['ci_upper']:.6f},"
                    f"{r['n_positive']},{r['n_total']}\n")


def save_benchmark_json(metrics: dict, classes: list[str], model_path: str,
                        out_path: str | Path, species_data=None, config=None,
                        num_files: int | None = None) -> None:
    """Structured JSON benchmark report; nan is written as null."""
    report: dict = {
        "model_path": str(model_path),
        "num_classes": len(classes),
        "num_files": int(num_files) if num_files is not None else 0,
        "num_chunks": metrics.get("total_chunks", 0),
    }
    core = {}
    for k, v in metrics.items():
        if k == "ap_per_class":
            continue
        if isinstance(v, float):
            # NaN (e.g. roc-auc on a single-class test set) must land as
            # null: json.dumps would emit a bare NaN token that every
            # non-Python JSON parser rejects.
            core[k] = None if not np.isfinite(v) else round(v, 6)
        else:
            core[k] = v
    report["metrics"] = core
    if species_data:
        report["species"] = species_data
    if config:
        report["config"] = config
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2, default=str))


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib
    (the only module of the port that imports it)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def save_training_curves_plot(history: list[dict], out_path) -> None:
    """Loss (train, val) and validation ROC-AUC per epoch (skips without
    matplotlib or history)."""
    plt = _pyplot()
    if plt is None or not history:
        return
    epochs = np.arange(1, len(history) + 1)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].plot(epochs, [h.get("loss", np.nan) for h in history], label="train")
    axes[0].plot(epochs, [h.get("val_loss", np.nan) for h in history], label="val")
    axes[0].set_title("loss")
    axes[0].set_xlabel("epoch")
    axes[0].legend()
    axes[1].plot(epochs, [h.get("val_roc_auc", np.nan) for h in history], label="val roc-auc")
    axes[1].set_title("ROC-AUC")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def save_confusion_matrix_plot(y_true, y_scores, classes, out_path, threshold: float = 0.5) -> None:
    """Matplotlib confusion heatmap (skips silently without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return
    cm = _top1_confusion(y_true, y_scores, len(classes), threshold)
    fig, ax = plt.subplots(figsize=(max(6, len(classes) * 0.5), max(5, len(classes) * 0.4)))
    im = ax.imshow(cm, interpolation="nearest", cmap=plt.cm.Blues)
    ax.figure.colorbar(im, ax=ax)
    ax.set(xticks=np.arange(len(classes)), yticks=np.arange(len(classes)),
           xticklabels=classes, yticklabels=classes,
           ylabel="True label", xlabel="Predicted label", title="Confusion Matrix")
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right", rotation_mode="anchor")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def save_det_curve_plot(far, frr, out_path) -> None:
    """Matplotlib DET plot (skips silently without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(far, frr, linewidth=1.5)
    ax.set_xlabel("False Acceptance Rate (FAR)")
    ax.set_ylabel("False Rejection Rate (FRR)")
    ax.set_title("Detection Error Tradeoff (DET) Curve")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.grid(True, alpha=0.3)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)


def _fig_to_base64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    return base64.b64encode(buf.getvalue()).decode()


def save_html_report(metrics: dict, classes: list[str], y_true, y_scores,
                     model_path: str, out_path: str | Path,
                     species_data=None, config=None) -> None:
    """Self-contained HTML report with base64-embedded charts (the charts
    only with matplotlib)."""
    plt = _pyplot()

    rows = "".join(
        f"<tr><td>{k}</td><td>{round(v, 6) if isinstance(v, float) else v}</td></tr>"
        for k, v in metrics.items() if k != "ap_per_class"
    )
    charts_html = ""
    if plt is not None:
        # score histogram
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.hist(np.asarray(y_scores).ravel(), bins=30, range=(0, 1))
        ax.set_title("Pooled score distribution")
        charts_html += f'<img src="data:image/png;base64,{_fig_to_base64(fig)}"/>'
        plt.close(fig)
        # per-class AP bars
        aps = metrics.get("ap_per_class")
        if aps:
            order = np.argsort(aps)[::-1]
            fig, ax = plt.subplots(figsize=(8, max(3, len(classes) * 0.18)))
            ax.barh([classes[i] for i in order][::-1], [aps[i] for i in order][::-1])
            ax.set_title("Per-class AP")
            charts_html += f'<img src="data:image/png;base64,{_fig_to_base64(fig)}"/>'
            plt.close(fig)

    species_html = ""
    if species_data:
        body = "".join(
            f"<tr><td>{r['class']}</td><td>{r['ap']:.4f}</td>"
            f"<td>[{r['ci_lower']:.4f}, {r['ci_upper']:.4f}]</td><td>{r['n_positive']}</td></tr>"
            for r in sorted(species_data, key=lambda r: r["ap"], reverse=True)
        )
        species_html = (
            "<h2>Per-species AP</h2><table><tr><th>class</th><th>AP</th>"
            "<th>95% CI</th><th>positives</th></tr>" + body + "</table>"
        )

    config_html = ""
    if config:
        config_html = "<h2>Config</h2><pre>" + json.dumps(config, indent=2, default=str) + "</pre>"

    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Evaluation report</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; max-width: 70rem; }}
table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc; padding: 4px 10px; }}
img {{ display: block; margin: 1rem 0; max-width: 100%; }}
</style></head><body>
<h1>Evaluation report</h1>
<p>model: <code>{model_path}</code> &middot; {len(classes)} classes</p>
<h2>Metrics</h2><table>{rows}</table>
{charts_html}
{species_html}
{config_html}
</body></html>
"""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(html)
