"""PyTorch port, the frontend benchmark entry and its throughput protocol.

`bench_frontend.run` on the CPU (the kernels' plain versions) at a small
batch: every section is there, the kernel's features agree with the
composition within 1e-5 (the linear gate of tests/test_pallas.py; on the
CPU both run the same plain maths) and the INT8 scores are finite. The
rates a CPU run prints are the CPU's: only a run on the card times the
kernels (chip_smoke.py runs this entry there).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.ops.kernels import frontend_kernel
from birdnet_stm32_tpu_torch.scripts import bench_frontend
from birdnet_stm32_tpu_torch.utils.benchmarking import sustained_chunks_per_sec
from tests.test_torch_cpu_warmup import warm_up
from tests.test_torch_serving import _port_sources

warm_up()

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def result():
    return bench_frontend.run(4, device="cpu", iters=1, reps=1)


def test_sustained_chunks_per_sec_protocol():
    """One warm-up call, then reps x iters calls each read once at the
    end; the rate is chunks over seconds, best of reps."""
    calls = []

    def fn(w):
        calls.append(1)
        return w.sum()

    wave = torch.ones(6, 10)
    rate = sustained_chunks_per_sec(fn, wave, iters=4, reps=2)
    assert len(calls) == 1 + 4 * 2
    assert math.isfinite(rate) and rate > 0


def test_bench_sections(result):
    assert result["device"] == "cpu"
    assert result["config"] == {"bundle": str(bench_frontend.BUNDLE), "T": 66150, "n_fft": 512,
                                "hop": 258, "W": 256, "B": 4, "iters": 1, "reps": 1}
    assert set(result) == {"device", "config", "numerics", "frontend", "e2e"}
    assert result["numerics"]["B"] == 32
    assert result["numerics"]["max_abs"] <= 1e-5
    f = result["frontend"]
    assert set(f["tile_grid"]) == {"2", "4"}  # 8 and 16 do not divide B=4
    for v in [f["composition"], f["sample_grid"]] + [t["chunks_per_s"] for t in
                                                     f["tile_grid"].values()]:
        assert math.isfinite(v) and v > 0
    assert f["sample_grid_max_abs_diff"] <= 1e-5
    for t in f["tile_grid"].values():
        assert t["finite"] and t["equals_sample_grid"] and t["max_abs_diff"] <= 1e-5
    e = result["e2e"]
    assert e["composition"] > 0 and e["sample_grid"] > 0
    assert e["agreement"]["finite"] and e["agreement"]["min_cosine"] >= 0.999


def test_bench_counts_entry_code_flips(result):
    """The agreement counts the graph's entry codes (QUANTIZE of the [32,
    257, 256, 1] features) that differ between the two feeds: at most one
    apart, on under 1 % of them, the repo's int8 gate."""
    a = result["e2e"]["agreement"]
    assert a["entry_codes"] == 32 * 257 * 256
    assert 0 <= a["entry_codes_differing"] < 0.01 * a["entry_codes"]
    assert a["max_entry_code_diff"] <= 1
    assert a["identical"] or a["entry_codes_differing"] > 0  # scores differ only by codes


def test_bench_report_lines(result):
    lines = bench_frontend.report(result)
    assert [line.split("]")[0] + "]" for line in lines] == (
        ["[cfg]", "[numerics]"] + ["[frontend]"] * 4 + ["[e2e]"] * 3)
    assert "tile=2" in lines[4] and "tile=4" in lines[5]


def test_bench_runs_on_the_cpu_plain_path():
    """On the CPU the bench launches no kernel; both grids go through the
    one plain version, so the tile grid equals the sample grid."""
    frontend_kernel.launches.clear()
    out = bench_frontend.run(2, device="cpu", iters=1, reps=1)
    assert frontend_kernel.launches.total() == 0
    f = out["frontend"]
    assert set(f["tile_grid"]) == {"2"} and f["tile_grid"]["2"]["equals_sample_grid"]
    assert f["tile_grid"]["2"]["max_abs_diff"] == f["sample_grid_max_abs_diff"]


def test_bench_defaults_to_cuda():
    """Without device=, the bench runs on CUDA; on a machine without it it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_frontend.run(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_frontend.main(["2"])


def test_bench_main_prints_json_last(capsys, monkeypatch):
    """main() prints the report lines, then the result as one JSON line."""
    run = bench_frontend.run
    monkeypatch.setattr(bench_frontend, "run", lambda B: run(B, device="cpu", iters=1, reps=1))
    bench_frontend.main(["2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[cfg]") and "B=2" in lines[0]
    last = json.loads(lines[-1])
    assert last["config"]["B"] == 2 and np.isfinite(last["numerics"]["max_abs"])


@pytest.mark.parametrize("module", ["utils/__init__.py", "utils/benchmarking.py",
                                    "utils/tracing.py", "scripts/__init__.py",
                                    "scripts/bench_frontend.py"])
def test_import_scan_covers_new_modules(module):
    """tests/test_torch_serving.py's scan for JAX imports reaches utils/ and
    scripts/ (both run on the card machine, which has no JAX)."""
    assert REPO / "birdnet_stm32_tpu_torch" / module in _port_sources()
