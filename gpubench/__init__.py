"""The benchmark of the PyTorch and CUDA port (birdnet_stm32_tpu_torch).

`python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once on the cards of the machine it
starts on. Configurations (configs/), traffic mixes (traffic/) and
per-layer metric readers (metrics/) are one file each, found by name. A
configuration names its `model`, and a model's plain reference
(reference/<model>.py) and its multiply-accumulates
(yardstick/macs_<model>.py) are files found by that name too; the plain
reference (reference/) and the fixed arithmetic (yardstick/) import
nothing of the port. It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

# A name that becomes a file's name (a model's, a metric's): BENCHMARK.json's
# name characters, no slash.
FILE_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_file(directory: Path, name: str):
    """`<directory>/<name>.py` executed as a fresh module, found by its path
    rather than imported as a member of a package, so that a new file needs
    no edit of an existing one."""
    path = directory / f"{name}.py"
    if not FILE_NAME.match(name) or not path.is_file():
        raise ValueError(f"no file {path} for the name {name!r}")
    spec = importlib.util.spec_from_file_location(f"gpubench_{directory.name}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # what a dataclass in the file looks up
    spec.loader.exec_module(mod)
    return mod
