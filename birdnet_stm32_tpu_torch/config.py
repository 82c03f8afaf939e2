"""Model configuration with JSON round-trip, validation, and legacy tolerance.

Behavioral contract mirrors the reference `ModelConfig`
(birdnet_stm32/training/config.py:15-148): the JSON sidecar written next to
every checkpoint is the single source of truth consumed by conversion,
evaluation, and serving. Configs written by the reference load here
unchanged (unknown keys are dropped), and vice versa.

The PyTorch port keeps its own copy of birdnet_stm32_tpu/config.py (the
port imports nothing of the JAX package); the two must stay identical in
behaviour, which tests/test_torch_frontend.py checks.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path

VALID_FRONTENDS = ("librosa", "hybrid", "raw", "mfcc", "log_mel")
VALID_MAG_SCALES = ("pwl", "pcen", "db", "none")

# Deprecated aliases accepted for compatibility with old reference configs
# (reference: models/frontend.py:24-53).
_FRONTEND_ALIASES = {"precomputed": "librosa", "tf": "raw"}


def normalize_frontend_name(name: str) -> str:
    """Map a frontend name (possibly a deprecated alias) to its canonical name.

    Args:
        name: Frontend name.

    Returns:
        Canonical name in VALID_FRONTENDS.

    Raises:
        ValueError: For unknown names.
    """
    if name in VALID_FRONTENDS:
        return name
    if name in _FRONTEND_ALIASES:
        canonical = _FRONTEND_ALIASES[name]
        warnings.warn(
            f"Frontend name {name!r} is deprecated, use {canonical!r} instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        return canonical
    raise ValueError(f"Invalid audio frontend: {name!r}. Valid options: {VALID_FRONTENDS}")


@dataclass
class ModelConfig:
    """Audio + architecture + class configuration.

    Field names and defaults match the reference schema so sidecar JSONs are
    interchangeable between the two frameworks.
    """

    # Audio
    sample_rate: int = 24000
    num_mels: int = 64
    spec_width: int = 256
    fft_length: int = 512
    chunk_duration: float = 3.0
    # STFT hop in samples. The reference computes hop at train time and
    # persists it (cli/train.py:324,449 there; always chunk_samples //
    # spec_width — its static default 281 is that formula at the default
    # 24 kHz/3 s/256-frame geometry). None -> computed from the geometry;
    # an inconsistent stored value (a stale sidecar) is healed with a
    # warning, since every consumer (trainer, firmware frontend) derives
    # frames from this same contract.
    hop_length: int | None = None
    audio_frontend: str = "hybrid"
    mag_scale: str = "pwl"
    n_mfcc: int = 20

    # Architecture. `architecture` names the registered model builder
    # (models/__init__.py::build_model); the knobs below it are the
    # DS-CNN's, an EfficientNet takes its variant's widths.
    architecture: str = "dscnn"
    embeddings_size: int = 256
    alpha: float = 1.0
    depth_multiplier: int = 1
    use_se: bool = True
    se_reduction: int = 8
    use_inverted_residual: bool = True
    expansion_factor: int = 2
    use_attention_pooling: bool = False
    dropout_rate: float = 0.5
    frontend_trainable: bool = False

    # Classes
    num_classes: int = 0
    class_names: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.audio_frontend = normalize_frontend_name(self.audio_frontend)
        positive = {
            "sample_rate": self.sample_rate,
            "num_mels": self.num_mels,
            "spec_width": self.spec_width,
            "fft_length": self.fft_length,
            "chunk_duration": self.chunk_duration,
            "alpha": self.alpha,
        }
        for name, value in positive.items():
            if value <= 0:
                raise ValueError(f"{name} must be positive, got {value}")
        if self.mag_scale not in VALID_MAG_SCALES:
            raise ValueError(f"mag_scale {self.mag_scale!r} not in {sorted(VALID_MAG_SCALES)}")
        if self.depth_multiplier < 1:
            raise ValueError(f"depth_multiplier must be >= 1, got {self.depth_multiplier}")
        if not 0 <= self.dropout_rate < 1:
            raise ValueError(f"dropout_rate must be in [0, 1), got {self.dropout_rate}")
        if self.num_classes < 0:
            raise ValueError(f"num_classes must be >= 0, got {self.num_classes}")
        if self.class_names and len(self.class_names) != self.num_classes:
            raise ValueError(
                f"class_names length ({len(self.class_names)}) != num_classes ({self.num_classes})"
            )
        expected_hop = self.compute_hop_length()
        if self.hop_length is None:
            self.hop_length = expected_hop
        elif self.hop_length != expected_hop:
            warnings.warn(
                f"hop_length={self.hop_length} is inconsistent with the "
                f"geometry contract chunk_samples // spec_width = "
                f"{expected_hop} (sample_rate={self.sample_rate}, "
                f"chunk_duration={self.chunk_duration}, "
                f"spec_width={self.spec_width}); healing to {expected_hop}. "
                "Re-save this sidecar to fix it permanently.",
                stacklevel=2,
            )
            self.hop_length = expected_hop

    # -- Derived quantities ---------------------------------------------------

    @property
    def chunk_samples(self) -> int:
        """Number of waveform samples in one chunk."""
        return int(self.sample_rate * self.chunk_duration)

    @property
    def fft_bins(self) -> int:
        """Number of rFFT bins."""
        return self.fft_length // 2 + 1

    @property
    def input_bins(self) -> int:
        """Frequency-axis size of the model input for this frontend."""
        if self.audio_frontend == "mfcc":
            return self.n_mfcc
        if self.audio_frontend == "hybrid":
            return self.fft_bins
        return self.num_mels

    def compute_hop_length(self) -> int:
        """Hop so that one chunk yields `spec_width` frames.

        Mirrors the reference contract hop = chunk_samples // spec_width
        (training/trainer.py:245-257, audio/spectrogram.py:61).
        """
        return max(1, self.chunk_samples // self.spec_width)

    def input_shape(self) -> tuple[int, ...]:
        """Per-example model input shape (without batch dim)."""
        if self.audio_frontend == "raw":
            return (self.chunk_samples, 1)
        return (self.input_bins, self.spec_width, 1)

    # -- Serialization ---------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=2) + "\n")

    @classmethod
    def from_dict(cls, data: dict) -> "ModelConfig":
        """Build from a dict, silently dropping unknown keys (legacy tolerance)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    @classmethod
    def load(cls, path: str | Path) -> "ModelConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))
