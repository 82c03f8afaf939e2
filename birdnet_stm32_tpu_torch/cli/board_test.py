"""Board-test CLI: a standalone end-to-end inference test over a WAV
directory (port of cli/board_test.py).

    python -m birdnet_stm32_tpu_torch board-test --model_path M --audio_dir DIR [--device cpu]

Where the firmware's board test flashes a board and parses its UART
stream, this runs the same loop on the local device (cli/benchmark.py::
run_benchmark): scan WAVs, decode and chunk, run the fused frontend and
model, print each file's top-K with [BENCH] timings, end with the
`=== DONE ===` summary and the real-time factor. The model, config,
labels, audio directory, top-K and batch come from the CLI, BIRDNET_TPU_*
variables or a JSON / TOML deploy config, in that order
(deploy/config.py); the config and labels paths are derived from a
`_quantized` model path. `--save_results` writes the file / top_label /
top_score CSV. `use_int8 = false` runs a .tflite through the TFLite
interpreter on the host (it needs TensorFlow). The port adds `--device`
(default cuda).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def get_args(argv=None):
    p = argparse.ArgumentParser(
        "birdnet_stm32_tpu_torch board-test",
        description=("Run standalone inference over a WAV directory: decode + "
                     "chunk on the host, fused frontend + model on the device, "
                     "results in the firmware's UART line protocol."),
    )
    p.add_argument("--model_path", "--model", dest="model_path", default="",
                   help="quantized .tflite or a run directory of train "
                        "(default: from deploy config)")
    p.add_argument("--model_config", default="",
                   help="model_config.json (default: derived from model path)")
    p.add_argument("--labels", default="", help="labels.txt")
    p.add_argument("--audio_dir", default="",
                   help="WAV directory (the SD-card audio/ analog; "
                        "default: from deploy config)")
    p.add_argument("--top_k", type=int, default=None,
                   help="Top-K predictions per file "
                        "(default: deploy config value, 3)")
    p.add_argument("--score_threshold", type=float, default=0.01,
                   help="Minimum score to display")
    p.add_argument("--config", default="",
                   help="deploy config file (JSON or TOML)")
    p.add_argument("--timeout", type=int, default=300,
                   help="Max seconds for the whole run (default: 300)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="Batch size (default: deploy config value, 64)")
    p.add_argument("--save_results", default="",
                   help="Save results summary to a CSV file")
    p.add_argument("--serial_port", default="",
                   help="accepted for compatibility (no UART: results stream "
                        "to stdout)")
    p.add_argument("--device", default="cuda",
                   help="device for ingress, frontend and model (default cuda; "
                        "raises without one; pass cpu for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)

    from birdnet_stm32_tpu_torch.cli.benchmark import run_benchmark
    from birdnet_stm32_tpu_torch.cli.deploy import derive_sidecar_paths
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.data.species import open_species_list
    from birdnet_stm32_tpu_torch.deploy.config import resolve_deploy_config
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner

    device = resolve_device(args.device)
    # Only values the user passed enter the CLI tier: argparse defaults
    # must not outrank the deploy config or the environment.
    cli_values = {"model_path": args.model_path or None,
                  "config_path": args.model_config or None,
                  "labels_path": args.labels or None,
                  "audio_dir": args.audio_dir or None,
                  "top_k": args.top_k, "batch_size": args.batch_size}
    try:
        dcfg = resolve_deploy_config(cli_values=cli_values,
                                     config_file=args.config or None)
    except FileNotFoundError as e:
        print(f"[ERROR] {e}")
        return 1

    if not dcfg.model_path:
        print("[ERROR] no model: pass --model_path or set it in the deploy config")
        return 1
    if not dcfg.audio_dir:
        print("[ERROR] no audio: pass --audio_dir or set it in the deploy config")
        return 1

    cfg_guess, labels_guess = derive_sidecar_paths(dcfg.model_path)
    config_path = Path(dcfg.config_path or cfg_guess)
    if not config_path.is_file():
        print(f"[ERROR] Model config not found ({config_path}). "
              "Supply --model_config path.")
        return 1
    cfg = ModelConfig.load(config_path)

    labels_path = Path(dcfg.labels_path or labels_guess)
    classes = (open_species_list(labels_path) if labels_path.is_file()
               else cfg.class_names)

    model_p = Path(dcfg.model_path)
    if not dcfg.use_int8 and model_p.suffix == ".tflite":
        # use_int8=false: the TFLite interpreter on the host in place of
        # the INT8 executor on the device (a cross-check of the executor).
        from birdnet_stm32_tpu_torch.models.runners import TFLiteInterpreterRunner

        runner = TFLiteInterpreterRunner(model_p)
    else:
        runner = load_model_runner(model_p, device=device)
    from birdnet_stm32_tpu_torch.data.dataset import supported_audio_extensions

    files = sorted(str(p) for p in Path(dcfg.audio_dir).rglob("*")
                   if p.suffix.lower() in supported_audio_extensions())
    if not files:
        print(f"[ERROR] no audio files under {dcfg.audio_dir}")
        return 1

    result = run_benchmark(runner, cfg, classes, files,
                           top_k=dcfg.top_k, batch_size=dcfg.batch_size,
                           overlap=dcfg.chunk_overlap,
                           # output_csv = benchmark-format rows; --save_results
                           # below writes the reference's 3-column format.
                           csv_path=dcfg.output_csv or None,
                           score_threshold=args.score_threshold,
                           timeout=args.timeout, device=device)

    if args.save_results and result["per_file"]:
        import csv

        with open(args.save_results, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["file", "top_label", "top_score"])
            for r in result["per_file"]:
                w.writerow([r["file"], r["top1"], f"{r['score']:.4f}"])
        print(f"\nResults saved to {args.save_results}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
