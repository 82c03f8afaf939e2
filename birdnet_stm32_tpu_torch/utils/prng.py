"""Deterministic randomness (port of utils/prng.py).

set_global_seed seeds Python's, numpy's and torch's global generators (the
host-side loader draws from numpy, the model's dropout from torch's
default generator). Device-side draws of the training batcher take an
explicit torch.Generator: the trainer holds one on the device and draws
from it step by step, so there is no key splitting.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_global_seed(seed: int) -> None:
    """Seed PYTHONHASHSEED, random, numpy and torch (every device)."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A torch.Generator on `device`, seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(int(seed))
