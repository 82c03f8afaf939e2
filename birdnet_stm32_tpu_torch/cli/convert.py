"""Convert CLI: a run directory of the port's `train` or a reference .keras
archive -> INT8 TFLite with the quality gate (port of cli/convert.py).

Stratified calibration sampling, PTQ / dynamic / float conversion,
validation with worst-case aggregation, the cosine gate, the validation
NPZ and the JSON report with the compression ratio. The port adds
`--device` (default cuda, for calibration features and validation; pass
cpu for the CPU).

The export needs TensorFlow: without it the verb exits with code 2 before
it loads or calibrates anything. A reference .keras archive is transplanted
(models/transplant.py) with `--model_config` as its sidecar (default
`<stem>_model_config.json`). `--stablehlo` also writes the portable serving
module, a torch.export program, as `<out>.pt2` beside the .tflite
(conversion/export_program.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def get_args(argv=None):
    p = argparse.ArgumentParser("birdnet_stm32_tpu_torch convert")
    p.add_argument("--model_path", "--checkpoint_path", required=True,
                   help="run directory of the port's train (or the .keras name train "
                        "mapped to one), or a reference .keras archive")
    p.add_argument("--data_path", "--data_path_train", default=None,
                   help="calibration audio directory (omitted: a random representative "
                        "dataset)")
    p.add_argument("--model_config", default=None,
                   help="config JSON for reference .keras inputs (run directories "
                        "carry their own)")
    p.add_argument("--output_path", default=None)
    p.add_argument("--quantize", "--quantization", default="int8",
                   choices=["int8", "ptq", "dynamic", "float"],
                   help="'ptq' is the reference spelling for full INT8")
    p.add_argument("--per_tensor", action="store_true")
    p.add_argument("--num_calibration_samples", "--num_samples", type=int, default=100)
    p.add_argument("--calibration_per_class", type=int, default=10)
    p.add_argument("--validate_samples", type=int, default=64,
                   help="validation sample count for the cosine gate")
    p.add_argument("--min_cosine_sim", type=float, default=0.95)
    p.add_argument("--num_validation_seeds", "--batch_validate", type=int, default=1)
    p.add_argument("--report_json", default=None,
                   help="also write the structured conversion report here")
    p.add_argument("--no_npz", action="store_true")
    p.add_argument("--stablehlo", action="store_true",
                   help="also export the waveform -> scores serving module as a "
                        "torch.export program (<out>.pt2)")
    p.add_argument("--onnx", "--export_onnx", action="store_true",
                   help="also export ONNX via tf2onnx when installed; prints a warning "
                        "and continues when it is not")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="device for calibration features and validation (default cuda; "
                        "raises without one; pass cpu for the CPU)")
    return p.parse_args(argv)


def _exit2(msg: str) -> int:
    print(f"[ERROR] {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = get_args(argv)
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        return _exit2("convert needs TensorFlow for the TFLite export, and it cannot be "
                      "imported here; convert on a machine with TensorFlow (the .tflite "
                      "it writes runs anywhere through the port's integer executor)")

    from birdnet_stm32_tpu_torch.conversion.pipeline import convert_model
    from birdnet_stm32_tpu_torch.data.dataset import load_file_paths_from_directory
    from birdnet_stm32_tpu_torch.training.checkpoint import keras_run_dir, load_checkpoint
    from birdnet_stm32_tpu_torch.utils.logging import ok

    if args.quantize == "ptq":
        args.quantize = "int8"
    model_path = Path(args.model_path)
    run_equiv = keras_run_dir(model_path)
    if run_equiv is not None:
        # train's --checkpoint_path name.keras trains into a run directory;
        # resolve the same way here.
        stem, out_default = model_path.stem, model_path.parent
        model, state_dict, cfg = load_checkpoint(run_equiv, device=args.device)
    elif model_path.suffix == ".keras":
        from birdnet_stm32_tpu_torch.models.transplant import load_reference_model

        config_path = Path(args.model_config) if args.model_config else (
            model_path.with_name(model_path.stem + "_model_config.json"))
        model, state_dict, cfg = load_reference_model(model_path, config_path,
                                                      device=args.device)
        stem, out_default = model_path.stem, model_path.parent
    else:
        stem, out_default = model_path.name, model_path
        model, state_dict, cfg = load_checkpoint(model_path, device=args.device)

    out_path = Path(args.output_path) if args.output_path else (
        out_default / f"{stem}_quantized.tflite")

    if args.data_path:
        paths, labels, _ = load_file_paths_from_directory(args.data_path,
                                                          classes=cfg.class_names)
        if not paths:
            # An explicit calibration directory with no usable file must not
            # fall back to random calibration data.
            raise SystemExit(
                f"no calibration audio under {args.data_path} "
                "(omit --data_path to calibrate on a random representative dataset)")
    else:
        paths, labels = None, None
    # class_activation=None: convert_model exports the head the checkpoint
    # was trained with (sigmoid for a multilabel run).
    report = convert_model(
        model, state_dict, cfg, out_path,
        calibration_paths=paths, calibration_labels=labels,
        calibration_per_class=args.calibration_per_class,
        num_calibration_samples=args.num_calibration_samples,
        quantize=args.quantize, per_channel=not args.per_tensor,
        min_cosine_sim=args.min_cosine_sim,
        num_validation_seeds=args.num_validation_seeds,
        num_validation_samples=args.validate_samples,
        class_activation=None, save_npz=not args.no_npz, seed=args.seed,
        device=args.device)
    ok("convert", f"{out_path} ({report['tflite_bytes']:,} B, "
                  f"{report['compression_ratio']:.1f}x compression)")
    if args.report_json:
        import json

        Path(args.report_json).write_text(json.dumps(report, indent=2, default=float))
        ok("convert", f"conversion report -> {args.report_json}")
    if args.stablehlo:
        from birdnet_stm32_tpu_torch.conversion.export_program import export_serving_fn

        program_path = out_path.with_suffix(".pt2")
        program_path.write_bytes(export_serving_fn(model, cfg, device=args.device))
        ok("convert", f"torch.export serving module -> {program_path}")
    if args.onnx:
        # Optional: an ONNX export failure never fails the conversion.
        try:
            import tf2onnx

            import tensorflow as tf

            from birdnet_stm32_tpu_torch.conversion.export_tflite import build_tf_forward
            from birdnet_stm32_tpu_torch.models.convert import state_dict_to_flax

            forward = build_tf_forward(state_dict_to_flax(state_dict), cfg,
                                       class_activation=report["class_activation"])
            spec = (tf.TensorSpec((None, *cfg.input_shape()), tf.float32),)
            onnx_path = out_path.with_suffix(".onnx")
            tf2onnx.convert.from_function(tf.function(forward), input_signature=spec,
                                          output_path=str(onnx_path))
            ok("convert", f"ONNX -> {onnx_path}")
        except ImportError:
            print("[WARN] --onnx requested but tf2onnx is not installed; skipping")
        except Exception as e:  # an ONNX export failure is not fatal
            print(f"[WARN] ONNX export failed ({type(e).__name__}: {e}); continuing")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
