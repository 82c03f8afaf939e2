"""Tagged `[tag] msg` logging with optional ANSI colour (port of
utils/logging.py, a copy). BIRDNET_TPU_QUIET silences it; NO_COLOR or a
non-terminal stdout drops the colour. Under a data-parallel process group
only rank 0 logs (parallel/distributed.py).
"""

from __future__ import annotations

import os
import sys
import time

_COLORS = {
    "reset": "\033[0m",
    "green": "\033[92m",
    "yellow": "\033[93m",
    "red": "\033[91m",
    "cyan": "\033[96m",
    "dim": "\033[2m",
}


def _use_color() -> bool:
    return sys.stdout.isatty() and os.environ.get("NO_COLOR") is None


def log(tag: str, msg: str, color: str | None = None) -> None:
    """Print a `[tag] msg` line, optionally colored."""
    if os.environ.get("BIRDNET_TPU_QUIET"):
        return
    from birdnet_stm32_tpu_torch.parallel.distributed import is_main_process

    if not is_main_process():
        return
    prefix = f"[{tag}]"
    if color and _use_color():
        prefix = f"{_COLORS.get(color, '')}{prefix}{_COLORS['reset']}"
    print(f"{prefix} {msg}", flush=True)


def info(tag: str, msg: str) -> None:
    log(tag, msg, color="cyan")


def ok(tag: str, msg: str) -> None:
    log(tag, msg, color="green")


def warn(tag: str, msg: str) -> None:
    log(tag, msg, color="yellow")


def error(tag: str, msg: str) -> None:
    log(tag, msg, color="red")


class Timer:
    """Context manager measuring wall time in milliseconds."""

    def __init__(self) -> None:
        self.ms = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.ms = (time.perf_counter() - self._t0) * 1000.0
