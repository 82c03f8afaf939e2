"""Checkpoints: the port's weights format and the reference's sidecar
contract (port of training/checkpoint.py).

A run directory holds:
    best/state_dict.pt    the best epoch's DSCNN state_dict (parameters and
                          BN statistics, CPU tensors)
    last/train_state.pt   the full training state after the last epoch:
                          step, params, buffers, optimizer state and the
                          batcher's generator state (resume)
    model_config.json     ModelConfig sidecar
    labels.txt            ordered class names
    train_state.json      {"epoch", "multilabel", "monitor", "best_val"}
    history.csv           per-epoch metrics
    curves.png            loss / ROC-AUC curves, where matplotlib imports

The JAX package writes best/ and last/ as orbax checkpoints; the port
cannot read those without orbax and tensorstore, and says so.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import torch

from birdnet_stm32_tpu_torch.config import ModelConfig

BEST = Path("best") / "state_dict.pt"
LAST = Path("last") / "train_state.pt"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(run_dir: str | Path, state_dict: dict, cfg: ModelConfig) -> None:
    """Write best/state_dict.pt, the config sidecar and labels.txt."""
    run_dir = Path(run_dir).absolute()
    (run_dir / BEST).parent.mkdir(parents=True, exist_ok=True)
    torch.save(_cpu(dict(state_dict)), run_dir / BEST)
    cfg.save(run_dir / "model_config.json")
    if cfg.class_names:
        (run_dir / "labels.txt").write_text("".join(f"{c}\n" for c in cfg.class_names))


def save_full_state(run_dir: str | Path, state, generator: torch.Generator | None = None) -> None:
    """The full training state under last/ (written after every epoch), so
    --resume continues mid-schedule with the optimizer's moments."""
    run_dir = Path(run_dir).absolute()
    (run_dir / LAST).parent.mkdir(parents=True, exist_ok=True)
    payload = {"step": int(state.step), "params": _cpu(state.params),
               "buffers": _cpu(state.buffers), "opt_state": _cpu(state.opt_state),
               "generator": None if generator is None else generator.get_state()}
    torch.save(payload, run_dir / LAST)


def _to(tree, like):
    if isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        return {k: _to(tree[k], v) for k, v in like.items()}
    return tree


def restore_full_state(run_dir: str | Path, state, generator: torch.Generator | None = None):
    """Load last/ into `state` (a fresh TrainState of the same model and
    optimizer) and `generator`. Returns None, leaving both as they were,
    when there is no last/ or it does not match (another architecture or
    optimizer)."""
    path = Path(run_dir).absolute() / LAST
    if not path.exists():
        return None
    try:
        saved = torch.load(path, map_location="cpu", weights_only=True)
        if (saved["params"].keys() != state.params.keys()
                or saved["buffers"].keys() != state.buffers.keys()
                or _keys(saved["opt_state"]) != _keys(state.opt_state)):
            return None
        opt_state = _to(saved["opt_state"], state.opt_state)
    except Exception:
        return None
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(saved["params"][k])
        for k, b in state.buffers.items():
            b.copy_(saved["buffers"][k])
    state.opt_state.update(opt_state)
    state.step = int(saved["step"])
    if generator is not None and saved.get("generator") is not None:
        generator.set_state(saved["generator"])
    return state


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def keras_run_dir(path: str | Path) -> Path | None:
    """The run directory a reference-style .keras path that does not exist
    maps to (train's --checkpoint_path ckpt/name.keras trains into ckpt/);
    None when `path` is a real file or no run directory matches."""
    p = Path(path)
    if p.suffix != ".keras" or p.exists():
        return None
    for cand in (p.with_suffix(""), p.parent):
        if (cand / "model_config.json").exists():
            return cand
    return None


def _is_multilabel(run_dir: Path) -> bool:
    state = Path(run_dir) / "train_state.json"
    if state.exists():
        return bool(json.loads(state.read_text()).get("multilabel", False))
    return False


def load_checkpoint(run_dir: str | Path, class_activation: str | None = None,
                    device: str | torch.device = "cuda"):
    """(model, state_dict, cfg) of a run directory's best/ weights: a
    DSCNN in eval mode on `device` with the weights loaded. The head is
    `class_activation`, else the one train_state.json records (sigmoid for
    a multilabel run, softmax otherwise)."""
    from birdnet_stm32_tpu_torch.models.dscnn import build_dscnn

    run_dir = Path(run_dir).absolute()
    if not (run_dir / BEST).exists():
        if (run_dir / "best").is_dir():
            raise ValueError(
                f"{run_dir}: best/ holds no state_dict.pt; a run directory the JAX "
                "package wrote keeps orbax checkpoints, which the port cannot read "
                "(that needs orbax and tensorstore)")
        raise FileNotFoundError(f"{run_dir / BEST} does not exist")
    cfg = ModelConfig.load(run_dir / "model_config.json")
    activation = class_activation or ("sigmoid" if _is_multilabel(run_dir) else "softmax")
    model = build_dscnn(cfg, class_activation=activation, device=device)
    state_dict = torch.load(run_dir / BEST, map_location="cpu", weights_only=True)
    model.load_state_dict(state_dict, strict=True)
    return model, state_dict, cfg


def save_train_state(run_dir: str | Path, epoch: int, **extra) -> None:
    """{"epoch": N, ...} for resume."""
    p = Path(run_dir) / "train_state.json"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"epoch": int(epoch), **extra}))


def load_train_state(run_dir: str | Path) -> dict:
    p = Path(run_dir) / "train_state.json"
    return json.loads(p.read_text()) if p.exists() else {}


def append_history_csv(run_dir: str | Path, epoch: int, metrics: dict) -> None:
    """Append one epoch's row (the header on the first write). A resumed
    run keeps the existing file's columns; an empty or truncated file gets
    a fresh header."""
    p = Path(run_dir) / "history.csv"
    write_header = not p.exists()
    fieldnames = ["epoch"] + sorted(metrics.keys())
    if not write_header:
        with open(p) as f:
            existing = f.readline().strip().split(",")
        if existing and existing[0] == "epoch":
            fieldnames = existing
        else:
            write_header = True
    with open(p, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        if write_header:
            writer.writeheader()
        row = {"epoch": epoch}
        row.update({k: f"{float(v):.6f}" for k, v in metrics.items()})
        writer.writerow(row)


def save_training_curves(run_dir: str | Path, history: list[dict]) -> None:
    """curves.png (loss and ROC-AUC per epoch), only where matplotlib imports."""
    from birdnet_stm32_tpu_torch.evaluation.reporting import save_training_curves_plot

    save_training_curves_plot(history, Path(run_dir) / "curves.png")
