"""Serving / deploy configuration with CLI > env > file precedence (port
of deploy/config.py).

A dataclass of deployment settings, resolved from (in order of
precedence) explicit CLI values, BIRDNET_TPU_* environment variables, and
a JSON or TOML config file (tomllib) with cross-format fallback. TOML takes
top-level keys and a [serving] table. The names, the environment prefix
and the default file names are the JAX package's, so one config file
serves either package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from pathlib import Path

ENV_PREFIX = "BIRDNET_TPU_"
DEFAULT_CONFIG_NAMES = ("birdnet_tpu.json", "birdnet_tpu.toml")


@dataclass
class DeployConfig:
    """Resolved serving configuration for the batch-inference driver."""

    model_path: str = ""
    config_path: str = ""
    labels_path: str = ""
    audio_dir: str = ""
    batch_size: int = 64
    top_k: int = 3
    chunk_overlap: float = 0.0
    use_int8: bool = True          # .tflite: the INT8 executor on the device
                                   # (True) or the TFLite interpreter (False)
    mesh_devices: int = 0          # kept for the file format; the port uses one device
    output_csv: str = ""
    extra: dict = field(default_factory=dict)

    def validate(self) -> None:
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.top_k <= 0:
            raise ValueError("top_k must be positive")
        if self.model_path and not Path(self.model_path).exists():
            raise FileNotFoundError(f"model_path does not exist: {self.model_path}")


def _load_file(path: Path) -> dict:
    """Parse JSON or TOML with cross-format fallback."""
    text = path.read_text()
    if path.suffix == ".toml":
        try:
            import tomllib

            data = tomllib.loads(text)
        except Exception:
            data = json.loads(text)  # cross-format fallback
    else:
        try:
            data = json.loads(text)
        except Exception:
            import tomllib

            data = tomllib.loads(text)
    # TOML layout: top-level scalars and/or a [serving] table.
    if isinstance(data.get("serving"), dict):
        merged = {k: v for k, v in data.items() if k != "serving"}
        merged.update(data["serving"])
        return merged
    return data


_CASTS = {"batch_size": int, "top_k": int, "mesh_devices": int,
          "chunk_overlap": float,
          "use_int8": lambda s: (s.lower() in ("1", "true", "yes")
                                 if isinstance(s, str) else bool(s))}


def _coerce(name: str, value):
    """Coerce a config-file/env value to the field's type (no-op when
    already correct)."""
    cast = _CASTS.get(name, str)
    try:
        return cast(value)
    except (TypeError, ValueError) as e:
        raise ValueError(f"deploy config field {name!r}: cannot interpret "
                         f"{value!r}") from e


def resolve_deploy_config(
    cli_values: dict | None = None,
    config_file: str | Path | None = None,
    search_dir: str | Path = ".",
) -> DeployConfig:
    """Resolve with precedence CLI > env > config file > defaults.

    Args:
        cli_values: Explicit values (None entries are ignored).
        config_file: Path to a JSON/TOML file; when None, the standard
            names are searched in `search_dir`.
        search_dir: Directory for the default config file search.

    Returns:
        A validated DeployConfig.
    """
    known = {f.name: f.type for f in fields(DeployConfig) if f.name != "extra"}
    resolved: dict = {}
    extra: dict = {}

    # 1. Config file (lowest precedence).
    path = Path(config_file) if config_file else None
    if path is None:
        for name in DEFAULT_CONFIG_NAMES:
            cand = Path(search_dir) / name
            if cand.exists():
                path = cand
                break
    if path is not None:
        if not path.exists():
            raise FileNotFoundError(f"config file not found: {path}")
        for k, v in _load_file(path).items():
            if k in known:
                # Coerce file values like the env path below does: a
                # hand-edited {"batch_size": "64"} must not reach
                # validate() as a string (TypeError on '<= 0').
                resolved[k] = _coerce(k, v)
            else:
                extra[k] = v

    # 2. Environment variables.
    for name in known:
        env = os.environ.get(ENV_PREFIX + name.upper())
        if env is not None:
            resolved[name] = _coerce(name, env)

    # 3. CLI (highest precedence).
    for k, v in (cli_values or {}).items():
        if v is None:
            continue
        (resolved if k in known else extra)[k] = v

    cfg = DeployConfig(**{k: v for k, v in resolved.items() if k in known})
    cfg.extra = extra
    cfg.validate()
    return cfg
