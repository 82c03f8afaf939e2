"""Train CLI: dataset discovery -> loaders -> training loop -> run directory
(port of cli/train.py).

    python -m birdnet_stm32_tpu_torch train --data_path_train DIR [--device cpu] ...

The flags and defaults are the JAX package's. Training runs on CUDA by
default (`--device cpu` for the CPU). Under torchrun it trains
data-parallel, one rank per process (parallel/distributed.py: NCCL where
each rank has a card of its own, else gloo), each rank loading its shard of
the files, with the global batch's step; only rank 0 writes the run
directory and logs:

    torchrun --nproc_per_node 2 -m birdnet_stm32_tpu_torch train ...

`--no_mesh` keeps one process's training even under torchrun's
environment. The feed is int16 by default (`--train_feed`): the
batcher dequantizes on the device, then the frontend kernel computes the
features. `--cache_dir` serves the decode from the decoded-waveform cache
(audio/io.py::cached_waveform).

The other modes, as in the JAX package:
- `--mixed_precision`: the step's forward and backward in bf16 on float32
  masters, bf16 features from the batcher;
- `--qat` fine-tunes the run in --run_dir with fake-quantized weights into
  `<run>_qat` (`--qat_act`: activations too), on its geometry, without
  upsampling or augmentation, at --qat_learning_rate (else
  --learning_rate if given, else 1e-5);
- `--linear_probe` trains a fresh head on the run's backbone into
  `<run>_probe`;
- `--find_lr` sweeps the learning rate and prints the suggestion;
- `--tune [N]` runs N trials of the search space (training/tuner.py) into
  `<run>/trial_N` and writes `<run>/best_params.json`.
The LR finder and the tuner train on the float32 feed.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

GEOMETRY = ("sample_rate", "chunk_duration", "num_mels", "spec_width", "fft_length",
            "audio_frontend", "mag_scale")


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
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 forward and backward; master weights, loss and optimizer "
                        "stay float32")
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
                   help="train in this process alone (no process group under torchrun)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for the CPU)")
    # Modes
    p.add_argument("--qat", action="store_true",
                   help="QAT fine-tune of the run in --run_dir into <run>_qat")
    p.add_argument("--qat_act", action="store_true",
                   help="with --qat: fake-quantize the input, activations and logits too")
    p.add_argument("--qat_learning_rate", type=float, default=None,
                   help="QAT learning rate (default: --learning_rate when given, else 1e-5)")
    p.add_argument("--linear_probe", action="store_true",
                   help="train a fresh head on the run's backbone into <run>_probe")
    p.add_argument("--find_lr", action="store_true", help="run the LR finder and exit")
    p.add_argument("--tune", type=int, nargs="?", const=-1, default=0, metavar="N",
                   help="search N trials (bare --tune takes --n_trials)")
    p.add_argument("--n_trials", type=int, default=20, help="trial count for bare --tune")
    args = p.parse_args(argv)
    if args.tune and args.tune < 0:
        args.tune = args.n_trials
    args.lr_given = args.learning_rate is not None
    if args.learning_rate is None:
        args.learning_rate = 1e-3
    if args.no_int16_feed:
        args.train_feed = "float32"
    return args


def build_loaders(args, for_qat: bool = False, ship: str = "float32"):
    """Discover files, split, upsample (not for QAT), and build the train
    and validation loaders. ship: the training feed, 'float32' | 'int16' |
    'ulaw'; validation always ships float32 (one chunk per file, fixed
    offsets, 5x the activity threshold, FIFO). Under a process group both
    loaders read this rank's shard of their files."""
    import dataclasses

    from birdnet_stm32_tpu_torch.data.dataset import (
        get_classes_with_most_samples,
        load_file_paths_from_directory,
        one_hot_labels,
        upsample_minority_classes,
    )
    from birdnet_stm32_tpu_torch.data.pipeline import AudioLoader, LoaderConfig
    from birdnet_stm32_tpu_torch.parallel.distributed import host_shard

    shard, num_shards = host_shard()
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

    if (not args.no_upsample and not for_qat
            and args.upsample_ratio and 0 < args.upsample_ratio < 1.0):
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
        batch_size=args.batch_size, num_workers=args.num_workers, executor="process",
        shard_index=shard, num_shards=num_shards)
    val_lcfg = dataclasses.replace(
        lcfg, random_offset=False, max_chunks_per_file=1,
        snr_threshold=args.snr_threshold * 5.0, ship_int16=False, ship_ulaw=False)
    val_loader = AudioLoader(
        val_paths, one_hot_labels(val_labels, class_names), val_lcfg,
        batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=False, infinite=False, shard_index=shard, num_shards=num_shards)
    return train_loader, val_loader, class_names, labels


def balanced_class_weights(labels: list[str], class_names: list[str]) -> np.ndarray:
    """n_samples / (n_classes * count_c), in one Counter pass."""
    from collections import Counter

    by_class = Counter(labels)
    counts = np.array([max(1, by_class.get(c, 0)) for c in class_names], np.float64)
    total = sum(by_class.get(c, 0) for c in class_names)
    return (total / (len(class_names) * counts)).astype(np.float32)




def _train_then_close(loader, fn):
    """fn(iterator of loader); the iterator is closed afterwards, which stops
    the loader's worker processes."""
    batches = iter(loader)
    try:
        return fn(batches)
    finally:
        batches.close()


def main(argv=None) -> int:
    args = get_args(argv)
    from birdnet_stm32_tpu_torch.parallel import distributed

    # Before anything else: the loaders' shards and the device follow the
    # rank (a no-op without torchrun's environment).
    joined = not args.no_mesh and distributed.initialize_distributed()
    try:
        return _main(args)
    finally:
        if joined:
            distributed.destroy()


def _main(args) -> int:
    from birdnet_stm32_tpu_torch.config import ModelConfig, normalize_frontend_name
    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.data.species import save_species_list
    from birdnet_stm32_tpu_torch.device import resolve_device
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
    from birdnet_stm32_tpu_torch.parallel.distributed import host_shard, local_device
    from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
    from birdnet_stm32_tpu_torch.training.trainer import AdaptiveLoaderTuner, train_model
    from birdnet_stm32_tpu_torch.utils.logging import info, ok
    from birdnet_stm32_tpu_torch.utils.prng import set_global_seed

    device = resolve_device(local_device(args.device))
    rank, world = host_shard()
    if world > 1 and (args.linear_probe or args.find_lr or args.tune):
        raise SystemExit("--linear_probe, --find_lr and --tune train in one process: "
                         "run them without torchrun or with --no_mesh")
    set_global_seed(args.seed)
    args.audio_frontend = normalize_frontend_name(args.audio_frontend)
    # The reference's head rule: mixup's label-union targets are multilabel,
    # so the head is sigmoid and the loss BCE whenever mixup is on. The QAT
    # and probe branches take the head from the base run instead.
    explicit_multilabel = args.multilabel
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
        args.run_dir = str(run_dir)
        info("train", f"--checkpoint_path file mapped to run dir {run_dir}")

    if args.qat_act and not args.qat:
        raise SystemExit("--qat_act requires --qat (it extends the QAT "
                         "fine-tune step; plain training never fake-quantizes)")

    def wave_features(batches, cfg):
        """(wave, labels) -> (features on the device, labels)."""
        for wave, labels in batches:
            yield frontend_input(torch.as_tensor(wave).to(device), cfg), labels

    if args.qat:
        from birdnet_stm32_tpu_torch.quant.qat import run_qat
        from birdnet_stm32_tpu_torch.training.checkpoint import _is_multilabel

        # The QAT fine-tune keeps the base run's head, geometry and feed;
        # no mixup, no augmentation, no upsampling.
        args.multilabel = explicit_multilabel or _is_multilabel(run_dir)
        cfg = ModelConfig.load(run_dir / "model_config.json")
        for f in GEOMETRY:
            setattr(args, f, getattr(cfg, f))
        train_loader, val_loader, class_names, _ = build_loaders(
            args, for_qat=True, ship=args.train_feed)
        qat_batcher = None
        if args.train_feed != "float32":
            qat_batcher = make_train_batcher(cfg, spec_augment=False, mixup_probability=0.0,
                                             input_dtype=args.train_feed)
        qat_lr = args.qat_learning_rate
        if qat_lr is None:
            qat_lr = args.learning_rate if args.lr_given else 1e-5
        _train_then_close(train_loader, lambda batches: run_qat(
            run_dir, batches, lambda: iter(val_loader),
            out_dir=(run_dir / f"{keras_stem}_qat") if keras_stem else None,
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch or 100,
            learning_rate=qat_lr, multilabel=args.multilabel,
            num_classes=len(class_names), seed=args.seed, batcher=qat_batcher,
            monitor=args.monitor, act_fq=args.qat_act, device=device))
        return 0

    cfg_kwargs = dict(
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

    if args.linear_probe:
        from birdnet_stm32_tpu_torch.training.checkpoint import load_checkpoint
        from birdnet_stm32_tpu_torch.training.linear_probe import run_linear_probe

        # The probe's head trains without mixup: only --multilabel makes it
        # sigmoid. Its loaders read at the base run's geometry.
        args.multilabel = explicit_multilabel
        _, base_sd, base_cfg = load_checkpoint(run_dir, class_activation="none",
                                               device=device)
        for f in GEOMETRY:
            setattr(args, f, getattr(base_cfg, f))
        train_loader, val_loader, class_names, _ = build_loaders(args)
        out = ((run_dir / f"{keras_stem}_probe") if keras_stem
               else run_dir.with_name(run_dir.name + "_probe"))
        _train_then_close(train_loader, lambda batches: run_linear_probe(
            base_sd, base_cfg, class_names, wave_features(batches, base_cfg),
            lambda: wave_features(iter(val_loader), base_cfg), out,
            epochs=args.epochs, steps_per_epoch=args.steps_per_epoch or 50,
            learning_rate=args.learning_rate, multilabel=args.multilabel,
            seed=args.seed, device=device))
        return 0

    # The LR finder and the tuner feed model inputs without the dequantizing
    # batcher: float32 waves.
    feed = args.train_feed if not (args.find_lr or args.tune) else "float32"
    train_loader, val_loader, class_names, raw_labels = build_loaders(args, ship=feed)
    cfg = ModelConfig(num_classes=len(class_names), class_names=class_names, **cfg_kwargs)
    info("train", f"{len(train_loader.paths)} train files, {len(val_loader.paths)} val "
                  f"files, {len(class_names)} classes, on {device}")

    if args.tune:
        return _run_tuning(args, cfg_kwargs, class_names, device)

    model = init_model(build_dscnn(cfg, class_activation="none", device=device), seed=args.seed)

    if args.find_lr:
        from birdnet_stm32_tpu_torch.training.lr_finder import run_lr_finder

        out = _train_then_close(train_loader, lambda batches: run_lr_finder(
            model, wave_features(batches, cfg),
            make_loss_fn(multilabel=args.multilabel, device=device)))
        ok("lr_finder", f"suggested learning rate: {out['suggested_lr']:.2e}")
        return 0

    steps = args.steps_per_epoch or max(
        20, train_loader.estimate_samples_per_epoch() // args.batch_size)
    # Smoothing is applied in the loss only (mixup never smooths).
    batcher = make_train_batcher(
        cfg, spec_augment=not args.no_spec_augment, mixup_alpha=args.mixup_alpha,
        mixup_probability=0.0 if args.no_mixup else args.mixup_probability,
        freq_mask_max=args.freq_mask_max, time_mask_max=args.time_mask_max,
        stft_precision="high" if args.mixed_precision else "highest",
        feature_dtype=torch.bfloat16 if args.mixed_precision else None,
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

    if rank == 0:
        run_dir.mkdir(parents=True, exist_ok=True)
        cfg.save(run_dir / "model_config.json")
        save_species_list(class_names, run_dir / "labels.txt")
        if keras_stem:
            cfg.save(run_dir / f"{keras_stem}_model_config.json")
            save_species_list(class_names, run_dir / f"{keras_stem}_labels.txt")

    _train_then_close(train_loader, lambda batches: train_model(
        model, cfg, batches, lambda: iter(val_loader), run_dir,
        epochs=args.epochs, steps_per_epoch=steps,
        learning_rate=args.learning_rate, optimizer=args.optimizer,
        weight_decay=args.weight_decay, gradient_clip_norm=args.gradient_clip_norm,
        patience=args.patience, multilabel=args.multilabel,
        focal_gamma=args.focal_gamma, label_smoothing=args.label_smoothing,
        class_weights=class_weights, batcher=batcher,
        resume=args.resume, resume_weights_only=args.resume_weights_only,
        seed=args.seed, loader_tuner=AdaptiveLoaderTuner(train_loader.loader_control),
        loss_fn_override=loss_fn_override, monitor=args.monitor, device=device,
        mixed_precision=args.mixed_precision))
    ok("train", f"artifacts in {run_dir}")
    return 0


def _run_tuning(args, cfg_kwargs: dict, class_names: list[str], device) -> int:
    """The tuner's study over the search space: each trial trains
    max(2, epochs // 5) epochs into <run_dir>/trial_N, reports its
    validation ROC-AUC per epoch (median pruning) and scores its best one."""
    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.data.pipeline import make_train_batcher
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn, init_model
    from birdnet_stm32_tpu_torch.training.trainer import train_model
    from birdnet_stm32_tpu_torch.training.tuner import run_tuning
    from birdnet_stm32_tpu_torch.utils.logging import info, ok

    def objective(trial):
        p = trial.params
        kw = dict(cfg_kwargs)
        kw.update(
            alpha=p["alpha"], depth_multiplier=p["depth_multiplier"],
            embeddings_size=p["embeddings_size"], dropout_rate=p["dropout_rate"],
            use_se=p["use_se"], se_reduction=p.get("se_reduction", 8),
            use_inverted_residual=p["use_inverted_residual"],
            expansion_factor=p.get("expansion_factor", 2),
            use_attention_pooling=p["use_attention_pooling"])
        cfg = ModelConfig(num_classes=len(class_names), class_names=class_names, **kw)
        args.batch_size = p["batch_size"]
        train_loader, val_loader, _, _ = build_loaders(args)
        model = init_model(build_dscnn(cfg, class_activation="none", device=device),
                           seed=args.seed + trial.number)
        batcher = make_train_batcher(cfg, mixup_probability=p["mixup_probability"])
        info("tune", f"trial {trial.number}: {p}")

        def report_epoch(epoch_i, metrics):
            # Median pruning at the epoch boundary, indexed by report count
            # so that a skipped nan epoch does not shift later ones.
            auc = metrics.get("val_roc_auc", float("nan"))
            if not np.isnan(auc):
                trial.report(auc, len(trial.intermediate))

        _, history = _train_then_close(train_loader, lambda batches: train_model(
            model, cfg, batches, lambda: iter(val_loader),
            Path(args.run_dir) / f"trial_{trial.number}",
            epochs=max(2, args.epochs // 5), steps_per_epoch=args.steps_per_epoch or 50,
            learning_rate=p["learning_rate"], optimizer=p["optimizer"],
            weight_decay=p["weight_decay"], gradient_clip_norm=p["gradient_clip_norm"],
            multilabel=args.multilabel, label_smoothing=p["label_smoothing"],
            batcher=batcher, seed=args.seed, on_epoch_end=report_epoch,
            monitor=args.monitor, device=device))
        return max((h["val_roc_auc"] for h in history
                    if not np.isnan(h["val_roc_auc"])), default=0.0)

    best = run_tuning(objective, args.tune, args.run_dir, seed=args.seed)
    ok("tune", f"best trial {best.number}: auc={best.value:.4f} -> "
               f"{Path(args.run_dir) / 'best_params.json'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
