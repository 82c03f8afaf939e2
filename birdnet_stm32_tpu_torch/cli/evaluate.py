"""Evaluate CLI: pooled file-level metrics and reports (port of
cli/evaluate.py).

    python -m birdnet_stm32_tpu_torch evaluate --model_path M --data_path_test DIR [--device cpu]

The flags and their spellings are the JAX package's: the metrics block
with the best and worst 10 APs, ASCII histogram / PR / DET curves and
confusion matrix, species and predictions CSVs, threshold optimisation,
bootstrap intervals, the benchmark JSON, the HTML report, latency and
memory profiling, embeddings. The port adds `--device` (default cuda;
nothing falls back to the CPU on its own). It evaluates .tflite models and
the run directories the port's `train` writes (float32, or bf16 with
`--bf16`); a reference .keras file or a JAX (orbax) run directory raises
(models/runners.py::load_model_runner).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser("birdnet_stm32_tpu_torch evaluate")
    p.add_argument("--model_path", required=True,
                   help=".tflite model or a run directory of train")
    p.add_argument("--data_path_test", required=True)
    p.add_argument("--config_path", "--model_config", default=None)
    p.add_argument("--pooling", default="average", choices=["average", "avg", "max", "lme"])
    p.add_argument("--lme_beta", type=float, default=10.0)
    p.add_argument("--chunk_overlap", "--overlap", type=float, default=0.0)
    p.add_argument("--max_duration", type=float, default=60.0,
                   help="per-file decode cap in seconds")
    p.add_argument("--cache_dir", default=None,
                   help="decoded-waveform cache directory: repeated "
                        "evaluations of the same test set (keras vs tflite, "
                        "threshold sweeps) decode each file only once")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="serve float checkpoints in bfloat16 (a .tflite ignores it)")
    p.add_argument("--decode_workers", type=int, default=0,
                   help=">0 prefetches file decode on N threads, overlapping "
                        "host decode with device inference")
    p.add_argument("--int16_io", action="store_true",
                   help="ship waveforms to the device as int16 PCM codes + "
                        "scale (bit-exact for mono PCM16 WAVs at the model "
                        "rate, ~1 LSB otherwise) — same transfer mode as "
                        "serve/benchmark --int16_io")
    p.add_argument("--ulaw_io", action="store_true",
                   help="ship waveforms as int8 mu-law codes (quarter "
                        "bandwidth, companded — NOT bit-exact; measures "
                        "the serving-side fidelity cost with the full "
                        "metrics stack)")
    p.add_argument("--benchmark_latency", action="store_true")
    p.add_argument("--profile_memory", action="store_true")
    p.add_argument("--optimize_thresholds", action="store_true")
    p.add_argument("--bootstrap_ci", action="store_true")
    p.add_argument("--n_bootstrap", type=int, default=1000,
                   help="bootstrap resamples for AP CIs (reference --n_bootstrap)")
    p.add_argument("--max_files", type=int, default=None,
                   help="evaluate at most N test files (reference --max_files; "
                        "values <= 0 mean all)")
    p.add_argument("--det_curve", action="store_true")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--save_csv", nargs="?", const=True, default=False,
                   metavar="CSV",
                   help="write predictions/species CSVs; an optional path "
                        "sets the predictions CSV file (reference --save_csv)")
    p.add_argument("--confusion_matrix", action="store_true",
                   help="accepted for compatibility (the ASCII confusion "
                        "matrix is always printed)")
    p.add_argument("--save_cm_plot", default=None, metavar="PNG",
                   help="confusion-matrix plot path (reference --save_cm_plot)")
    p.add_argument("--save_det_plot", default=None, metavar="PNG",
                   help="DET curve plot path (reference --save_det_plot)")
    p.add_argument("--save_html", action="store_true")
    p.add_argument("--report_html", default=None, metavar="HTML",
                   help="write the HTML report to this path")
    p.add_argument("--species_report", default=None, metavar="CSV",
                   help="write the per-species AP CSV to this path "
                        "(--save_csv also writes one into --output_dir)")
    p.add_argument("--save_plots", action="store_true",
                   help="confusion-matrix PNG (and DET PNG with --det_curve)")
    p.add_argument("--save_benchmark_json", nargs="?", const=True, default=False,
                   metavar="JSON",
                   help="write the benchmark JSON report; an optional path "
                        "overrides the destination (reference --benchmark)")
    p.add_argument("--benchmark", dest="save_benchmark_json", metavar="JSON",
                   default=argparse.SUPPRESS,
                   help="the other spelling of --save_benchmark_json PATH")
    p.add_argument("--save_embeddings", default=None, metavar="NPZ",
                   help="write per-file pooled embeddings (mean over chunks) "
                        "to an NPZ (float checkpoints only)")
    p.add_argument("--device", default="cuda",
                   help="device for ingress, frontend and model (default cuda; "
                        "raises without one; pass cpu for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    if args.int16_io and args.ulaw_io:
        raise SystemExit("--int16_io and --ulaw_io are mutually exclusive")

    import torch

    from birdnet_stm32_tpu_torch.cli.deploy import resolve_config_path
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.data.dataset import load_file_paths_from_directory
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.evaluation import metrics as M
    from birdnet_stm32_tpu_torch.evaluation import reporting as R
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner

    model_path = Path(args.model_path)
    dtype = torch.bfloat16 if args.bf16 else None
    device = resolve_device(args.device)
    args.config_path = resolve_config_path(model_path, args.config_path)
    runner = load_model_runner(model_path, dtype=dtype, device=device)
    cfg = getattr(runner, "cfg", None)
    if cfg is None:
        if args.config_path is None:
            raise SystemExit("--config_path required for .tflite models "
                             "(no model_config.json sidecar found next to "
                             f"{model_path})")
        cfg = ModelConfig.load(args.config_path)
    classes = cfg.class_names

    # --max_files caps each class (a random subset per class), not the
    # whole list, which would drop the alphabetically late classes.
    cap = args.max_files if args.max_files is not None and args.max_files > 0 else None
    files, _, _ = load_file_paths_from_directory(
        args.data_path_test, classes=classes, max_samples_per_class=cap)
    if not files:
        # Tell an empty directory from one whose class folders the model
        # does not know (a label mismatch, not missing data).
        any_files, _, found_classes = load_file_paths_from_directory(
            args.data_path_test)
        if any_files:
            raise SystemExit(
                f"no test audio under {args.data_path_test} matches the "
                f"model's classes {classes[:5]}{'...' if len(classes) > 5 else ''} "
                f"(found class folders: {sorted(found_classes)[:8]})")
        raise SystemExit(f"no test audio under {args.data_path_test}")

    results, per_file, y_true, y_scores = M.evaluate(
        runner, files, classes, cfg,
        pooling=args.pooling, batch_size=args.batch_size,
        overlap=args.chunk_overlap, mep_beta=args.lme_beta,
        measure_latency=args.benchmark_latency, profile_memory=args.profile_memory,
        decode_workers=args.decode_workers, max_duration=args.max_duration,
        cache_dir=args.cache_dir, int16_io=args.int16_io,
        ulaw_io=args.ulaw_io, device=device)

    print("\n=== Evaluation ===")
    for k in ("roc-auc", "cmAP", "mAP", "precision", "recall", "f1",
              "latency_mean_ms", "latency_median_ms", "latency_p95_ms",
              "latency_p99_ms", "blocking_read_floor_ms",
              "latency_mean_device_est_ms", "total_chunks", "peak_rss_mb"):
        if k in results:
            v = results[k]
            print(f"{k:>26}: {v:.4f}" if isinstance(v, float) else f"{k:>26}: {v}")
    if "latency_note" in results:
        print(f"[note] {results['latency_note']}")

    # The best and worst 10 APs.
    aps = dict(zip(classes, results.get("ap_per_class", [])))
    valid = [(c, a) for c, a in aps.items() if not np.isnan(a)]
    if valid:
        ranked = sorted(valid, key=lambda kv: -kv[1])
        print("\nbest species by AP:")
        for c, a in ranked[:10]:
            print(f"  {c:<40} {a:.4f}")
        if len(ranked) > 10:
            print("worst species by AP:")
            for c, a in ranked[-10:]:
                print(f"  {c:<40} {a:.4f}")

    R.print_ascii_histogram(y_scores.ravel())
    R.print_ascii_pr_curve(y_true, y_scores)
    R.print_confusion_matrix(y_true, y_scores, classes)

    # Default report destination: a run directory holds its own reports; a
    # model file writes next to itself.
    out_dir = (Path(args.output_dir) if args.output_dir
               else (model_path if model_path.is_dir() else model_path.parent))
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.optimize_thresholds:
        th = M.optimize_thresholds(y_true, y_scores, classes)
        (out_dir / "thresholds.json").write_text(json.dumps(th, indent=2))
        print(f"[evaluate] per-class thresholds -> {out_dir / 'thresholds.json'}")
        # The operating point at the optimised thresholds, computed as the
        # row at 0.5 above.
        opt = M.metrics_at_thresholds(y_true, y_scores, th, classes)
        print(f"[evaluate] @optimized thresholds: "
              f"precision={opt['precision']:.4f} recall={opt['recall']:.4f} "
              f"f1={opt['f1']:.4f}")
        results["precision_opt"] = opt["precision"]
        results["recall_opt"] = opt["recall"]
        results["f1_opt"] = opt["f1"]
    species_data = None
    if (args.bootstrap_ci or args.save_csv or args.species_report
            or args.report_html or args.save_html or args.save_benchmark_json):
        species_data = M.bootstrap_ap_ci(
            y_true, y_scores, classes,
            n_bootstrap=args.n_bootstrap if args.bootstrap_ci else 50)
    if args.det_curve:
        far, frr, _ = M.compute_det_curve(y_true, y_scores)
        R.print_ascii_det_curve(far, frr)
        R.save_det_curve_plot(far, frr, out_dir / "det_curve.png")
    if args.save_plots or args.save_cm_plot:
        R.save_confusion_matrix_plot(y_true, y_scores, classes,
                                     args.save_cm_plot or out_dir / "confusion_matrix.png")
    if args.save_det_plot:
        far, frr, _ = M.compute_det_curve(y_true, y_scores)
        R.save_det_curve_plot(far, frr, args.save_det_plot)
    if args.save_csv:
        csv_path = (Path(args.save_csv) if isinstance(args.save_csv, str)
                    else out_dir / "predictions.csv")
        R.save_predictions_csv(per_file, classes, csv_path)
        R.save_species_report_csv(species_data, out_dir / "species_report.csv")
    if args.species_report:
        R.save_species_report_csv(species_data, Path(args.species_report))
    if args.save_benchmark_json:
        json_path = (Path(args.save_benchmark_json)
                     if isinstance(args.save_benchmark_json, str)
                     else out_dir / "benchmark.json")
        R.save_benchmark_json(results, classes, str(model_path), json_path,
                              species_data=species_data, config=cfg.to_dict(),
                              num_files=len(per_file))
    if args.save_embeddings:
        from birdnet_stm32_tpu_torch.models.serving import make_embedder

        try:
            embed = make_embedder(runner, cfg, device=device)
        except TypeError as e:
            print(f"[WARN] --save_embeddings skipped: {e}")
        else:
            names, embs = [], []
            for rec in per_file:
                # The chunks the scores came from (same cap and cache).
                chunks = M.chunks_for_file(rec["file"], cfg, args.chunk_overlap,
                                           args.max_duration, None,
                                           args.cache_dir)
                if chunks.shape[0] == 0:
                    continue
                b = args.batch_size
                parts = []
                for i in range(0, len(chunks), b):
                    w = chunks[i : i + b]
                    n = w.shape[0]
                    if n < b:
                        w = np.pad(w, ((0, b - n), (0, 0)))
                    parts.append(embed(w)[:n])
                names.append(rec["file"])
                embs.append(np.concatenate(parts).mean(axis=0))
            if not embs:
                print("[WARN] --save_embeddings skipped: no file yielded chunks")
            else:
                np.savez(args.save_embeddings,
                         files=np.array(names),
                         labels=np.array([r["label"] for r in per_file
                                          if r["file"] in set(names)]),
                         embeddings=np.stack(embs).astype(np.float32))
                print(f"[evaluate] embeddings [{len(names)}, {embs[0].shape[0]}] "
                      f"-> {args.save_embeddings}")
    if args.save_html or args.report_html:
        html_path = (Path(args.report_html) if args.report_html
                     else out_dir / "report.html")
        R.save_html_report(results, classes, y_true, y_scores, str(model_path),
                           html_path,
                           species_data=species_data, config=cfg.to_dict())
        print(f"[evaluate] HTML report -> {html_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
