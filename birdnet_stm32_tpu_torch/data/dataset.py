"""Audio file extensions the port decodes (port of data/dataset.py's
AUDIO_EXTENSIONS and supported_audio_extensions).

The port decodes WAV only (audio/io.py, numpy); the compressed formats the
JAX package reads through its native libav codec are not ported
(ROADMAP.md).
"""

from __future__ import annotations

AUDIO_EXTENSIONS = (".wav",)


def supported_audio_extensions() -> tuple:
    """The extensions serve picks up: WAV only."""
    return AUDIO_EXTENSIONS
