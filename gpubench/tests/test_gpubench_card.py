"""A short run of each one-card cell on the card, every answer compared
with the reference at the cell's own sizes. Needs a CUDA device; skips
without one:

    python -m pytest gpubench/tests/test_gpubench_card.py -m cuda -q
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
ONE_CARD = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD)
def test_cell_is_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line, checks = harness.run_cell(workload, 2**31 + 3, 1.0, False, time.perf_counter())
    assert line["correct"], checks
    assert line["metrics"]["chunks_per_s"]["value"] > 0
