"""Deploy CLI: package a model into a deployment bundle (port of
cli/deploy.py).

The bundle holds the model (an INT8 .tflite, a run directory of the port's
`train` or a reference .keras archive), its model_config.json and
labels.txt, per-class thresholds when there are any, the reference STM32N6
firmware's `app_config.h` / `app_labels.h` (deploy/headers.py), with
`--stablehlo` the portable serving module `serving_module.pt2` (a
torch.export program of waveform -> scores at the deploy config's batch
size: the INT8 executor for a .tflite, the float model otherwise;
conversion/export_program.py), and a manifest of every file's sha256 and
size. Stages, as the reference's stedgeai flow:

  generate  -> collect and copy the artifacts, generate the headers, write
               the manifest
  validate  -> load the bundle back through load_model_runner and classify
               one batch through make_fused_classifier on the device
               (default cuda, `--device cpu` for the CPU), checking the
               output geometry

`--dry_run` prints the plan, `--skip_validate` skips validation, and the
reference's vendor-toolchain flags are accepted and ignored. The
sidecar-path helpers are shared with the serving verbs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import time
from pathlib import Path

# The serving module's bundle name (the JAX bundle's serving_module.bin holds
# StableHLO bytes; this one holds a saved torch.export program).
PROGRAM_NAME = "serving_module.pt2"


def get_args(argv=None):
    p = argparse.ArgumentParser("birdnet_stm32_tpu_torch deploy")
    p.add_argument("--model_path", "--model", dest="model_path", default="",
                   help="quantized .tflite (or a run directory of the port's train, or a "
                        "reference .keras archive)")
    p.add_argument("--model_config", default="",
                   help="model_config.json (default: derived from model path)")
    p.add_argument("--labels", default="",
                   help="labels.txt (default: derived from model path)")
    p.add_argument("--output_dir", default="",
                   help="bundle output directory (default: <model>_deploy/)")
    p.add_argument("--config", default="",
                   help="deploy config file (JSON or TOML); CLI > env > file")
    p.add_argument("--thresholds", default="",
                   help="per-class thresholds JSON to ship in the bundle (evaluate "
                        "--optimize_thresholds output). Default: thresholds.json next "
                        "to the model or config if present")
    p.add_argument("--stablehlo", action="store_true",
                   help="also export the serving function as a torch.export program "
                        "(serving_module.pt2)")
    p.add_argument("--dry_run", action="store_true",
                   help="print the deployment plan without executing it")
    # The reference's vendor-toolchain paths: accepted so its invocations
    # parse; the bundle shells out to no vendor tool.
    for flag in ("--stedgeai_path", "--x_cube_ai_path", "--cubeide_path",
                 "--arm_toolchain_path", "--workspace_dir", "--n6_loader_config"):
        p.add_argument(flag, default="", help=argparse.SUPPRESS)
    p.add_argument("--skip_validate", action="store_true",
                   help="skip the on-device validation step")
    p.add_argument("--device", default="cuda",
                   help="device of the validation batch (default cuda; raises without "
                        "one; pass cpu for the CPU)")
    return p.parse_args(argv)


def derive_sidecar_paths(model_path: str) -> tuple[str, str]:
    """(config path, labels path) derived from a model path: strip the
    extension and a `_quantized` suffix, then append `_model_config.json` /
    `_labels.txt`. Directory checkpoints hold their sidecars inside."""
    p = Path(model_path)
    if p.is_dir():
        return str(p / "model_config.json"), str(p / "labels.txt")
    root = str(p.with_suffix("")).replace("_quantized", "")
    cfg = root + "_model_config.json"
    if not Path(cfg).exists():
        if (p.parent / "model_config.json").exists():
            # A .tflite inside a run directory or bundle
            # (run/model_quantized.tflite next to run/model_config.json).
            return str(p.parent / "model_config.json"), str(p.parent / "labels.txt")
        if (Path(root) / "model_config.json").exists():
            # `<run>_quantized.tflite` exported next to the run directory.
            return str(Path(root) / "model_config.json"), str(Path(root) / "labels.txt")
    return cfg, root + "_labels.txt"


def resolve_config_path(model_path, config_path=None):
    """An explicit config_path wins; otherwise the derived sidecar when it
    exists on disk, else None."""
    if config_path:
        return str(config_path)
    cfg, _ = derive_sidecar_paths(str(model_path))
    return cfg if Path(cfg).exists() else None


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def build_bundle(model_path: Path, config_path: Path, labels_path: Path | None,
                 out_dir: Path, stablehlo: bool = False, dry_run: bool = False,
                 batch_size: int = 64, thresholds_path: Path | None = None,
                 device: str = "cuda") -> dict:
    """Assemble the deployment bundle; returns the manifest dict. With
    `stablehlo` the serving module is exported on `device`."""
    from birdnet_stm32_tpu_torch.config import ModelConfig

    cfg = ModelConfig.load(config_path)
    labels = None
    if labels_path is not None and labels_path.exists():
        # Raw line order, no dedupe or sort: label i stays aligned with
        # model output i.
        from birdnet_stm32_tpu_torch.data.species import load_species_list

        labels = load_species_list(labels_path)
    elif cfg.class_names:
        labels = list(cfg.class_names)
    if labels is not None and cfg.num_classes and len(labels) != cfg.num_classes:
        # APP_NUM_CLASSES and the APP_LABELS table disagreeing would make the
        # firmware index past the label array on the device.
        raise SystemExit(
            f"labels file has {len(labels)} entries but the model outputs "
            f"{cfg.num_classes} classes — refusing to generate mismatched "
            "firmware headers")

    plan = [
        ("copy", model_path, out_dir / model_path.name),
        ("copy", config_path, out_dir / "model_config.json"),
    ]
    if labels_path is not None and labels_path.exists():
        plan.append(("copy", labels_path, out_dir / "labels.txt"))
    # Per-class thresholds: an explicit path wins; otherwise next to the
    # model, then next to the config (where `evaluate --optimize_thresholds`
    # without --output_dir writes them).
    candidates = ([thresholds_path] if thresholds_path else
                  [model_path.parent / "thresholds.json",
                   config_path.parent / "thresholds.json"])
    for thresholds in candidates:
        if thresholds and thresholds.exists():
            plan.append(("copy", thresholds, out_dir / "thresholds.json"))
            break
    else:
        if thresholds_path:
            raise SystemExit(f"--thresholds not found: {thresholds_path}")
    if labels is not None:
        plan.append(("generate", "app_config.h + app_labels.h", out_dir / "firmware"))
    if stablehlo:
        plan.append(("export", "torch.export serving module", out_dir / PROGRAM_NAME))

    if dry_run:
        print("[deploy] dry run — planned actions:")
        for action, src, dst in plan:
            print(f"  {action:<9} {src} -> {dst}")
        return {"dry_run": True, "actions": len(plan)}

    out_dir.mkdir(parents=True, exist_ok=True)
    files: dict[str, dict] = {}
    for action, src, dst in plan:
        if action == "copy":
            if Path(src).resolve() != Path(dst).resolve():
                if Path(src).is_dir():
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                else:
                    shutil.copy2(src, dst)
            if dst.is_dir():
                files[dst.name] = {
                    "bytes": sum(f.stat().st_size for f in dst.rglob("*") if f.is_file())
                }
            else:
                files[dst.name] = {"sha256": _sha256(dst), "bytes": dst.stat().st_size}
            print(f"[deploy] {src} -> {dst}")

    if labels is not None:
        from birdnet_stm32_tpu_torch.deploy.headers import write_headers

        hdr_cfg, hdr_labels = write_headers(cfg, labels, out_dir / "firmware")
        for p in (hdr_cfg, hdr_labels):
            files[f"firmware/{p.name}"] = {"sha256": _sha256(p), "bytes": p.stat().st_size}
        print(f"[deploy] firmware headers -> {hdr_cfg.parent}")

    if stablehlo:
        from birdnet_stm32_tpu_torch.conversion import export_program as X

        if model_path.suffix == ".tflite":
            blob = X.export_int8_serving_fn(model_path, cfg, batch_size=batch_size,
                                            device=device)
        else:
            from birdnet_stm32_tpu_torch.models.runners import load_model_runner

            runner = load_model_runner(model_path, device=device, config_path=config_path)
            blob = X.export_serving_fn(runner.model, cfg, batch_size=batch_size, device=device)
        dst = out_dir / PROGRAM_NAME
        dst.write_bytes(blob)
        files[dst.name] = {"sha256": _sha256(dst), "bytes": dst.stat().st_size}
        print(f"[deploy] torch.export serving module -> {dst} ({len(blob)} bytes)")

    manifest = {
        "model": model_path.name,
        "num_classes": cfg.num_classes,
        "audio_frontend": cfg.audio_frontend,
        "sample_rate": cfg.sample_rate,
        "chunk_duration": cfg.chunk_duration,
        "files": files,
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(f"[deploy] manifest -> {out_dir / 'manifest.json'}")
    return manifest


def validate_bundle(out_dir: Path, model_name: str, batch_size: int = 8,
                    device: str = "cuda") -> dict:
    """Load the bundle back and classify one batch of silence on `device`
    (the `stedgeai validate --mode target` analog): proves the deployed
    artifact runs end to end where it will serve. A failure on the device
    raises."""
    import numpy as np

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.runners import load_model_runner
    from birdnet_stm32_tpu_torch.models.serving import make_fused_classifier

    cfg = ModelConfig.load(out_dir / "model_config.json")
    runner = load_model_runner(out_dir / model_name, device=device,
                               config_path=out_dir / "model_config.json")
    classify = make_fused_classifier(runner, cfg, device=device)
    wave = np.zeros((batch_size, cfg.chunk_samples), np.float32)
    t0 = time.perf_counter()
    scores = np.asarray(classify(wave))
    dt = time.perf_counter() - t0
    if scores.shape != (batch_size, cfg.num_classes):
        raise RuntimeError(
            f"validation failed: output shape {scores.shape}, "
            f"expected {(batch_size, cfg.num_classes)}")
    print(f"[deploy] validate OK: {scores.shape} scores in {dt * 1000:.1f} ms "
          "(first batch: includes building the executor)")
    return {"output_shape": list(scores.shape), "first_batch_ms": dt * 1000}


def main(argv=None) -> int:
    args = get_args(argv)
    from birdnet_stm32_tpu_torch.deploy.config import resolve_deploy_config

    cli_values = {"model_path": args.model_path or None,
                  "config_path": args.model_config or None,
                  "labels_path": args.labels or None}
    try:
        dcfg = resolve_deploy_config(cli_values=cli_values, config_file=args.config or None)
    except FileNotFoundError as e:
        print(f"[ERROR] {e}")
        return 1

    if not dcfg.model_path:
        print("[ERROR] no model: pass --model_path or set it in the deploy config")
        return 1
    model_path = Path(dcfg.model_path)

    cfg_guess, labels_guess = derive_sidecar_paths(str(model_path))
    config_path = Path(dcfg.config_path or cfg_guess)
    labels_path = Path(dcfg.labels_path or labels_guess)

    # Pre-flight checks.
    missing = [str(p) for p in (model_path, config_path) if not p.exists()]
    if missing:
        print(f"[ERROR] missing required files: {', '.join(missing)}")
        return 1
    if not labels_path.exists():
        print(f"[WARN] labels file not found ({labels_path}); "
              "falling back to config class_names")
        labels_path = None

    out_dir = Path(args.output_dir) if args.output_dir else (
        model_path.parent / (model_path.stem + "_deploy"))
    print(f"[deploy] model:  {model_path}")
    print(f"[deploy] config: {config_path}")
    print(f"[deploy] bundle: {out_dir}")

    build_bundle(model_path, config_path, labels_path, out_dir, stablehlo=args.stablehlo,
                 dry_run=args.dry_run, batch_size=dcfg.batch_size,
                 thresholds_path=Path(args.thresholds) if args.thresholds else None,
                 device=args.device)
    if args.dry_run:
        return 0
    if not args.skip_validate:
        validate_bundle(out_dir, model_path.name, device=args.device)
    print("[deploy] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
