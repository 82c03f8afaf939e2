"""The training loop: cosine LR, early stopping, best checkpoints,
resume (port of training/trainer.py).

Each step takes a loader batch to the device, runs the batcher (dequant,
the frontend kernel, augmentation; default: the frontend only) and the
train step (parallel/steps.py). After each epoch the validation batches
go through the frontend kernel and the eval step; the epoch's loss, val
loss (batch-size weighted), macro ROC-AUC and stage times go to
history.csv, the full state to last/, the best weights to best/.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from birdnet_stm32_tpu_torch.config import ModelConfig
from birdnet_stm32_tpu_torch.device import resolve_device
from birdnet_stm32_tpu_torch.evaluation.ranking import roc_auc_score
from birdnet_stm32_tpu_torch.models.blocks import BN_MOMENTUM
from birdnet_stm32_tpu_torch.ops.kernels.frontend_kernel import frontend_input
from birdnet_stm32_tpu_torch.parallel.steps import TrainState, make_eval_step, make_train_step
from birdnet_stm32_tpu_torch.training import checkpoint as ckpt
from birdnet_stm32_tpu_torch.training.losses import make_loss_fn
from birdnet_stm32_tpu_torch.training.optimizer import build_optimizer, cosine_schedule
from birdnet_stm32_tpu_torch.utils.prng import generator


def _log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def macro_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Macro ROC-AUC over the label columns with both classes present
    (degenerate columns are skipped; nan when none is left). numpy only
    (evaluation/ranking.py)."""
    aucs = []
    for c in range(y_true.shape[1]):
        col = y_true[:, c]
        if 0 < col.sum() < len(col):
            aucs.append(roc_auc_score((col > 0.5).astype(np.float64), np.asarray(y_score[:, c])))
    return float(np.mean(aucs)) if aucs else float("nan")


@dataclass
class AdaptiveLoaderTuner:
    """Hill-climbs the loader's max_inflight_files against the step rate."""

    loader_control: dict
    measure_every: int = 200
    step_lo: int = 16
    step_hi: int = 256
    _t0: float = field(default_factory=time.perf_counter)
    _count: int = 0
    _last_rate: float = 0.0
    _direction: int = 1

    def on_step(self) -> None:
        self._count += 1
        if self._count % self.measure_every:
            return
        now = time.perf_counter()
        rate = self.measure_every / (now - self._t0)
        self._t0 = now
        if self._last_rate and rate < self._last_rate * 0.98:
            self._direction = -self._direction
        cur = int(self.loader_control.get("max_inflight_files", 64))
        new = int(np.clip(cur + self._direction * 16, self.step_lo, self.step_hi))
        self.loader_control["max_inflight_files"] = new
        self._last_rate = rate


def train_model(
    model: torch.nn.Module,
    cfg: ModelConfig,
    train_batches: Iterator[tuple[np.ndarray, np.ndarray]],
    val_batches: Callable[[], Iterable[tuple[np.ndarray, np.ndarray]]],
    run_dir: str | Path,
    epochs: int = 50,
    steps_per_epoch: int = 100,
    learning_rate: float = 1e-3,
    optimizer: str = "adam",
    weight_decay: float = 0.0,
    gradient_clip_norm: float = 1.0,
    patience: int = 10,
    multilabel: bool = False,
    focal_gamma: float | None = None,
    label_smoothing: float = 0.0,
    class_weights: np.ndarray | None = None,
    batcher=None,
    resume: bool = False,
    resume_weights_only: bool = False,
    seed: int = 0,
    loader_tuner: AdaptiveLoaderTuner | None = None,
    loss_fn_override=None,
    kernel_l2: float = 1e-4,
    on_epoch_end=None,
    monitor: str = "val_loss",
    device: str | torch.device = "cuda",
) -> tuple[dict, list[dict]]:
    """Train `model` (a DSCNN built with class_activation='none', moved to
    `device`, default CUDA) and return (best state_dict, history).

    train_batches is an infinite iterator of numpy (wave, labels) batches;
    val_batches a zero-argument callable giving a finite iterable of the
    same ([B, T] waves get the frontend kernel, batches of more dimensions
    are taken as model inputs). batcher(generator, wave, labels) -> (x, y)
    is the device transform (data/pipeline.py::make_train_batcher); None
    computes the features only. It draws from one torch.Generator on the
    device, seeded with `seed` and saved in last/ for resume. monitor
    'val_loss' (lower is better) or 'val_roc_auc' picks the best epoch and
    drives early stopping after `patience` stale epochs. resume continues
    from run_dir: best/ weights, epoch, best-value watermark and (unless
    resume_weights_only) the full state of last/.
    """
    dev = resolve_device(device)
    model.to(dev)
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)

    if monitor not in ("val_loss", "val_roc_auc"):
        raise ValueError(f"monitor must be 'val_loss' or 'val_roc_auc', got {monitor!r}")
    lower_better = monitor == "val_loss"
    initial_epoch = 0
    resumed_best_val = float("inf") if lower_better else float("-inf")
    if resume and (run_dir / "best").exists():
        _log("resume", f"loading checkpoint from {run_dir}")
        _, state_dict, _ = ckpt.load_checkpoint(run_dir, class_activation="none", device="cpu")
        model.load_state_dict(state_dict, strict=True)
        tstate = ckpt.load_train_state(run_dir)
        initial_epoch = int(tstate.get("epoch", 0))
        # The watermark is comparable only under the same monitor.
        if tstate.get("best_val") is not None:
            if tstate.get("monitor", "val_loss") == monitor:
                resumed_best_val = float(tstate["best_val"])
            else:
                _log("resume", f"previous run monitored {tstate.get('monitor', 'val_loss')!r}, "
                     f"this one {monitor!r}: best-checkpoint watermark reset, so the "
                     "existing best/ may be replaced by the first epoch that improves "
                     "on the new metric")
        _log("resume", f"resuming from epoch {initial_epoch}")

    total_steps = (epochs - initial_epoch) * steps_per_epoch
    bn_settle = int(3.0 / max(1e-6, 1.0 - BN_MOMENTUM))  # ~300 at 0.99
    if not resume and total_steps < bn_settle:
        _log("train", f"only {total_steps} total steps: BatchNorm running statistics "
             f"(momentum {BN_MOMENTUM}) need ~{bn_settle} steps to wash out their "
             "init, so val metrics and saved checkpoints under-report the model until "
             "then. Raise --epochs/--steps_per_epoch for real runs.")
    schedule = cosine_schedule(learning_rate, epochs, steps_per_epoch)
    tx = build_optimizer(optimizer, schedule, weight_decay, gradient_clip_norm)
    loss_fn = loss_fn_override if loss_fn_override is not None else make_loss_fn(
        multilabel=multilabel, focal_gamma=focal_gamma,
        label_smoothing=label_smoothing, class_weights=class_weights, device=dev)
    step_fn = make_train_step(model, tx, loss_fn, frontend_trainable=cfg.frontend_trainable,
                              kernel_l2=kernel_l2)
    eval_fn = make_eval_step(model, loss_fn, activation="sigmoid" if multilabel else "softmax")

    gen = generator(seed, dev)
    state = TrainState.create(model, tx)
    if resume and initial_epoch > 0 and not resume_weights_only:
        if ckpt.restore_full_state(run_dir, state, gen) is not None:
            _log("resume", f"optimizer state restored (step {state.step}: moments and "
                 "schedule position continue)")
        else:
            _log("resume", "no full-state checkpoint; the optimizer restarts fresh")

    if batcher is None:
        def batcher(_generator, wave, labels):
            return frontend_input(wave, cfg), labels

    history: list[dict] = []
    best_val = resumed_best_val
    best_variables = state.variables()
    bad_epochs = 0
    saved_any = False

    for epoch in range(initial_epoch, epochs):
        t0 = time.perf_counter()
        train_losses = []
        # Host time blocked on the loader (data) and spent issuing the copy,
        # batcher and step (dispatch): the device runs behind the host.
        t_data = t_dispatch = 0.0
        for _ in range(steps_per_epoch):
            t1 = time.perf_counter()
            wave, labels = next(train_batches)
            t2 = time.perf_counter()
            x, y = batcher(gen, torch.as_tensor(wave).to(dev), torch.as_tensor(labels).to(dev))
            state, metrics = step_fn(state, x, y)
            t_data += t2 - t1
            t_dispatch += time.perf_counter() - t2
            train_losses.append(metrics["loss"])
            if loader_tuner is not None:
                loader_tuner.on_step()

        t_val0 = time.perf_counter()
        val_num, val_den, y_true, y_score = 0.0, 0, [], []
        for wave, labels in val_batches():
            w = torch.as_tensor(wave).to(dev)
            x = w if w.ndim > 2 else frontend_input(w, cfg)
            loss, scores = eval_fn(state, x, torch.as_tensor(labels).to(dev))
            b = int(x.shape[0])
            # Batch-size weighted: a partial tail batch does not skew the mean.
            val_num += float(loss) * b
            val_den += b
            y_true.append(np.asarray(labels))
            y_score.append(scores.cpu().numpy())

        # One device read for the epoch's losses.
        train_loss = float(np.mean(torch.stack(train_losses).cpu().numpy()))
        val_loss = val_num / val_den if val_den else float("nan")
        if y_true:
            yt, ys = np.concatenate(y_true), np.concatenate(y_score)
            auc = macro_roc_auc(yt[:, : ys.shape[1]], ys)
        else:
            auc = float("nan")
        epoch_metrics = {
            "loss": train_loss,
            "val_loss": val_loss,
            "val_roc_auc": auc,
            "seconds": time.perf_counter() - t0,
            "data_wait_s": round(t_data, 3),
            "dispatch_s": round(t_dispatch, 3),
            "val_s": round(time.perf_counter() - t_val0, 3),
        }
        history.append(epoch_metrics)
        ckpt.append_history_csv(run_dir, epoch + 1, epoch_metrics)
        mval = val_loss if lower_better else auc
        improved = (np.isfinite(mval)
                    and (mval < best_val if lower_better else mval > best_val))
        new_best = mval if improved else best_val
        ckpt.save_train_state(
            run_dir, epoch + 1, multilabel=multilabel, monitor=monitor,
            best_val=None if not np.isfinite(new_best) else new_best)
        ckpt.save_full_state(run_dir, state, gen)
        if on_epoch_end is not None:
            on_epoch_end(epoch, epoch_metrics)
        _log("train", f"epoch {epoch + 1}/{epochs} loss={train_loss:.4f} "
             f"val_loss={val_loss:.4f} val_auc={auc:.4f}")

        if improved:
            best_val = mval
            best_variables = state.variables()
            ckpt.save_checkpoint(run_dir, best_variables, cfg)
            _log("train", f"new best {monitor}={mval:.4f}, checkpoint saved")
            saved_any = True
            bad_epochs = 0
        else:
            if not lower_better and not np.isfinite(mval) and not saved_any:
                _log("train", f"{monitor} is NaN (degenerate validation labels?): "
                     "no best checkpoint saved yet")
            bad_epochs += 1
            if bad_epochs >= patience:
                _log("train", f"early stopping after {patience} stale epochs")
                break

    if not saved_any and not (resume and (run_dir / "best").exists()):
        # A metric that never went finite must not leave the run without
        # best/: save the final epoch's weights and say so.
        _log("train", f"{monitor} never improved/went finite: saving the FINAL "
             "epoch's weights as best/ so the run stays usable")
        best_variables = state.variables()
        ckpt.save_checkpoint(run_dir, best_variables, cfg)

    ckpt.save_training_curves(run_dir, history)
    return best_variables, history
