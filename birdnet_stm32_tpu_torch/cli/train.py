"""Train CLI: dataset discovery -> loaders -> training loop -> run directory
(port of cli/train.py, the standard path).

    python -m birdnet_stm32_tpu_torch train --data_path_train DIR [--device cpu] ...

The flags and defaults are the JAX package's. Training runs on one device,
CUDA by default (`--device cpu` for the CPU); `--no_mesh` is accepted and
changes nothing. The feed is int16 by default (`--train_feed`): the
batcher dequantizes on the device, then the frontend kernel computes the
features. `--cache_dir` serves the decode from the decoded-waveform cache
(audio/io.py::cached_waveform). The QAT, linear-probe, LR-finder, tuning
and mixed-precision options are not ported yet (ROADMAP.md Queue 1 item 9)
and exit with code 2.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

NOT_PORTED_FLAGS = ("qat", "qat_act", "linear_probe", "find_lr", "tune",
                    "mixed_precision")


def get_args(argv=None):
    p = argparse.ArgumentParser("birdnet_stm32_tpu_torch train")
    # Data
    p.add_argument("--data_path_train", required=True)
    p.add_argument("--data_path_val", default=None)
    p.add_argument("--val_split", type=float, default=0.2)
    p.add_argument("--top_n_classes", "--max_classes", type=int, default=None,
                   help="use the top N classes by sample count")
    p.add_argument("--max_samples_per_class", "--max_samples", type=int, default=None)
    p.add_argument("--upsample_ratio", type=float, default=0.5)
    p.add_argument("--no_upsample", action="store_true")
    p.add_argument("--max_chunks_per_file", type=int, default=2)
    p.add_argument("--snr_threshold", type=float, default=0.1,
                   help="activity-ratio threshold on waveform chunks")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--prefetch_batches", type=int, default=None,
                   help="accepted for compatibility (the in-flight depth is tuned "
                        "by AdaptiveLoaderTuner)")
    # Audio / frontend
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--chunk_duration", type=float, default=3.0)
    p.add_argument("--fft_length", type=int, default=512)
    p.add_argument("--num_mels", type=int, default=64)
    p.add_argument("--spec_width", type=int, default=256)
    p.add_argument("--audio_frontend", default="hybrid")
    p.add_argument("--mag_scale", default="pwl")
    p.add_argument("--no_frontend_trainable", action="store_true")
    p.add_argument("--frontend_trainable", action="store_true",
                   help="accepted for compatibility (trainable is the default; "
                        "--no_frontend_trainable freezes)")
    # Architecture
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--depth_multiplier", type=int, default=1)
    p.add_argument("--embeddings_size", type=int, default=256)
    p.add_argument("--dropout_rate", "--dropout", type=float, default=0.5)
    p.add_argument("--no_se", action="store_true")
    p.add_argument("--se_reduction", type=int, default=8)
    p.add_argument("--no_inverted_residual", action="store_true")
    p.add_argument("--expansion_factor", type=int, default=2)
    p.add_argument("--attention_pooling", "--use_attention_pooling",
                   dest="attention_pooling", action="store_true")
    # Optimization
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = estimate from data")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=None, help="default 1e-3")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "adamw"])
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--gradient_clip_norm", "--grad_clip", type=float, default=1.0)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--monitor", default="val_loss", choices=["val_loss", "val_roc_auc"],
                   help="best-checkpoint / early-stop criterion")
    p.add_argument("--multilabel", action="store_true")
    p.add_argument("--focal_gamma", type=float, default=None)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--no_class_weights", action="store_true")
    # Augmentation
    p.add_argument("--mixup_alpha", type=float, default=0.2)
    p.add_argument("--mixup_probability", type=float, default=0.25)
    p.add_argument("--no_mixup", action="store_true")
    p.add_argument("--no_spec_augment", action="store_true")
    p.add_argument("--freq_mask_max", type=int, default=8,
                   help="SpecAugment max frequency-mask width (bins)")
    p.add_argument("--time_mask_max", type=int, default=25,
                   help="SpecAugment max time-mask width (frames)")
    p.add_argument("--mixed_precision", action="store_true", help="not ported yet")
    p.add_argument("--loss", default="auto", choices=["auto", "bce", "cce", "focal"],
                   help="override the auto-selected loss")
    p.add_argument("--max_duration", type=float, default=30.0,
                   help="max seconds decoded per file during loading")
    p.add_argument("--train_feed", default="int16", choices=["int16", "ulaw", "float32"],
                   help="host-to-device waveform encoding: int16 (default, half the "
                        "float32 bytes, raw PCM16 codes dequantized bit-exactly on the "
                        "device), ulaw (a quarter, ~2.2%% relative error) or float32")
    p.add_argument("--no_int16_feed", action="store_true",
                   help="deprecated alias for --train_feed float32")
    p.add_argument("--cache_dir", default=None,
                   help="decoded-waveform cache directory: each file is decoded and "
                        "resampled once, later epochs read memmap slices")
    p.add_argument("--n_mfcc", type=int, default=20, help="MFCC coefficients (mfcc frontend)")
    # Run control
    p.add_argument("--run_dir", "--checkpoint_path", dest="run_dir",
                   default="runs/birdnet_tpu",
                   help="run directory (a .keras file path maps to its directory)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--resume_weights_only", action="store_true",
                   help="with --resume: restore the best weights and epoch only and "
                        "restart the optimizer")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_mesh", action="store_true",
                   help="accepted; the port trains on one device")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for the CPU)")
    # Modes of the JAX package not ported yet
    p.add_argument("--qat", action="store_true", help="not ported yet")
    p.add_argument("--qat_act", action="store_true", help="not ported yet")
    p.add_argument("--qat_learning_rate", type=float, default=None)
    p.add_argument("--linear_probe", action="store_true", help="not ported yet")
    p.add_argument("--find_lr", action="store_true", help="not ported yet")
    p.add_argument("--tune", type=int, nargs="?", const=-1, default=0, metavar="N",
                   help="not ported yet")
    p.add_argument("--n_trials", type=int, default=20)
    args = p.parse_args(argv)
    if args.tune and args.tune < 0:
        args.tune = args.n_trials
    args.lr_given = args.learning_rate is not None
    if args.learning_rate is None:
        args.learning_rate = 1e-3
    if args.no_int16_feed:
        args.train_feed = "float32"
    return args


def build_loaders(args, ship: str = "float32"):
    """Discover files, split, upsample, and build the train and validation
    loaders. ship: the training feed, 'float32' | 'int16' | 'ulaw';
    validation always ships float32 (one chunk per file, fixed offsets,
    5x the activity threshold, FIFO)."""
    import dataclasses

    from birdnet_stm32_tpu_torch.data.dataset import (
        get_classes_with_most_samples,
        load_file_paths_from_directory,
        one_hot_labels,
        upsample_minority_classes,
    )
    from birdnet_stm32_tpu_torch.data.pipeline import AudioLoader, LoaderConfig

    rng = np.random.default_rng(args.seed)
    classes = None
    if args.top_n_classes:
        classes = get_classes_with_most_samples(args.data_path_train, args.top_n_classes)
    paths, labels, class_names = load_file_paths_from_directory(
        args.data_path_train, classes=classes,
        max_samples_per_class=args.max_samples_per_class, rng=rng)
    if not paths:
        raise SystemExit(f"no audio files under {args.data_path_train}")

    if args.data_path_val:
        val_paths, val_labels, _ = load_file_paths_from_directory(
            args.data_path_val, classes=class_names, rng=rng)
    else:
        idx = rng.permutation(len(paths))
        n_val = max(1, int(len(paths) * args.val_split))
        val_paths = [paths[i] for i in idx[:n_val]]
        val_labels = [labels[i] for i in idx[:n_val]]
        paths = [paths[i] for i in idx[n_val:]]
        labels = [labels[i] for i in idx[n_val:]]

    if not args.no_upsample and args.upsample_ratio and 0 < args.upsample_ratio < 1.0:
        # Ratios >= 1 would duplicate every class past the former maximum.
        paths, labels = upsample_minority_classes(paths, labels, args.upsample_ratio, rng)

    lcfg = LoaderConfig(
        sample_rate=args.sample_rate, chunk_duration=args.chunk_duration,
        num_classes=len(class_names), max_chunks_per_file=args.max_chunks_per_file,
        snr_threshold=args.snr_threshold, seed=args.seed,
        load_duration=args.max_duration, cache_dir=getattr(args, "cache_dir", None),
        ship_int16=ship == "int16", ship_ulaw=ship == "ulaw")
    # The port decodes in numpy, which takes the interpreter lock between
    # its calls: decode threads would stall the train step's host-side
    # launches (17x on an H100 machine, PERF.md), so the train loader
    # decodes in a spawn process pool. Validation runs between steps and
    # keeps the threads.
    train_loader = AudioLoader(
        paths, one_hot_labels(labels, class_names), lcfg,
        batch_size=args.batch_size, num_workers=args.num_workers, executor="process")
    val_lcfg = dataclasses.replace(
        lcfg, random_offset=False, max_chunks_per_file=1,
        snr_threshold=args.snr_threshold * 5.0, ship_int16=False, ship_ulaw=False)
    val_loader = AudioLoader(
        val_paths, one_hot_labels(val_labels, class_names), val_lcfg,
        batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=False, infinite=False)
    return train_loader, val_loader, class_names, labels


def balanced_class_weights(labels: list[str], class_names: list[str]) -> np.ndarray:
    """n_samples / (n_classes * count_c), in one Counter pass."""
    from collections import Counter

    by_class = Counter(labels)
    counts = np.array([max(1, by_class.get(c, 0)) for c in class_names], np.float64)
    total = sum(by_class.get(c, 0) for c in class_names)
    return (total / (len(class_names) * counts)).astype(np.float32)


def main(argv=None) -> int:
    args = get_args(argv)
    unported = [f"--{f}" for f in NOT_PORTED_FLAGS if getattr(args, f) not in (None, False, 0)]
    if unported:
        print(f"train {' '.join(unported)}: not ported yet (ROADMAP.md Queue 1 item 9)",
              file=sys.stderr)
        return 2

    from birdnet_stm32_tpu_torch.config import ModelConfig, normalize_frontend_name
    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.data.species import save_species_list
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.trainer import AdaptiveLoaderTuner, train_model
    from birdnet_stm32_tpu_torch.utils.prng import set_global_seed

    device = resolve_device(args.device)
    set_global_seed(args.seed)
    args.audio_frontend = normalize_frontend_name(args.audio_frontend)
    # The reference's head rule: mixup's label-union targets are multilabel,
    # so the head is sigmoid and the loss BCE whenever mixup is on.
    if not args.no_mixup and args.mixup_probability > 0:
        args.multilabel = True
    run_dir = Path(args.run_dir)
    keras_stem = None
    if run_dir.suffix == ".keras":
        # A reference --checkpoint_path names a .keras file: train into its
        # directory and also write <stem>_model_config.json and
        # <stem>_labels.txt there.
        keras_stem = run_dir.stem
        run_dir = run_dir.parent
        print(f"[train] --checkpoint_path file mapped to run dir {run_dir}")

    feed = args.train_feed
    train_loader, val_loader, class_names, raw_labels = build_loaders(args, ship=feed)
    cfg = ModelConfig(
        num_classes=len(class_names), class_names=class_names,
        sample_rate=args.sample_rate, chunk_duration=args.chunk_duration,
        fft_length=args.fft_length, num_mels=args.num_mels, spec_width=args.spec_width,
        audio_frontend=args.audio_frontend, mag_scale=args.mag_scale,
        alpha=args.alpha, depth_multiplier=args.depth_multiplier,
        embeddings_size=args.embeddings_size, dropout_rate=args.dropout_rate,
        use_se=not args.no_se, se_reduction=args.se_reduction,
        use_inverted_residual=not args.no_inverted_residual,
        expansion_factor=args.expansion_factor,
        use_attention_pooling=args.attention_pooling,
        frontend_trainable=not args.no_frontend_trainable,
        n_mfcc=args.n_mfcc)
    print(f"[train] {len(train_loader.paths)} train files, {len(val_loader.paths)} val "
          f"files, {len(class_names)} classes, on {device}")

    model = init_model(build_dscnn(cfg, class_activation="none", device=device), seed=args.seed)
    steps = args.steps_per_epoch or max(
        20, train_loader.estimate_samples_per_epoch() // args.batch_size)
    # Smoothing is applied in the loss only (mixup never smooths).
    batcher = make_train_batcher(
        cfg, spec_augment=not args.no_spec_augment, mixup_alpha=args.mixup_alpha,
        mixup_probability=0.0 if args.no_mixup else args.mixup_probability,
        freq_mask_max=args.freq_mask_max, time_mask_max=args.time_mask_max,
        input_dtype=feed if feed != "float32" else None)
    class_weights = None if args.no_class_weights else balanced_class_weights(
        raw_labels, class_names)

    loss_fn_override = None
    if args.loss != "auto":
        loss_fn_override = make_loss_fn(
            multilabel=args.loss == "bce",
            focal_gamma=(args.focal_gamma or 2.0) if args.loss == "focal" else None,
            label_smoothing=args.label_smoothing, class_weights=class_weights,
            device=device)

    run_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(run_dir / "model_config.json")
    save_species_list(class_names, run_dir / "labels.txt")
    if keras_stem:
        cfg.save(run_dir / f"{keras_stem}_model_config.json")
        save_species_list(class_names, run_dir / f"{keras_stem}_labels.txt")

    train_batches = iter(train_loader)
    try:
        train_model(
            model, cfg, train_batches, lambda: iter(val_loader), run_dir,
            epochs=args.epochs, steps_per_epoch=steps,
            learning_rate=args.learning_rate, optimizer=args.optimizer,
            weight_decay=args.weight_decay, gradient_clip_norm=args.gradient_clip_norm,
            patience=args.patience, multilabel=args.multilabel,
            focal_gamma=args.focal_gamma, label_smoothing=args.label_smoothing,
            class_weights=class_weights, batcher=batcher,
            resume=args.resume, resume_weights_only=args.resume_weights_only,
            seed=args.seed, loader_tuner=AdaptiveLoaderTuner(train_loader.loader_control),
            loss_fn_override=loss_fn_override, monitor=args.monitor, device=device)
    finally:
        train_batches.close()  # stops the loader's worker processes
    print(f"[train] artifacts in {run_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
