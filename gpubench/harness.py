"""One run of one cell: set-up, the measured window, the trace, the
comparison with the reference, and the result line.

The cell, its configuration and its traffic mix are found by name from
BENCHMARK.json in the working directory (the checkout's root): the
configuration's file is the `file` BENCHMARK.json gives (it names its
`model`, and a float runner's `builder`: gpubench/system.py), the mix is
gpubench/traffic/<traffic>.json, and each per-layer metric is read by
gpubench/metrics/<name>.py.

Set-up (`setup_s`, host clock from the start of the process): import
torch and the port, build the runner (the kernel library loads from the
port's fixed build directory inside the checkout), make the seeded weights
on the card, make the request pool on the host, and serve every batch of
the pool `warmup_rounds` times. The window: a closed loop of one client for
`--seconds`; the last request, started before the close, is waited for and
counted, and the window ends when it ends. `chunks_per_s` is every chunk
answered over the whole window; `request_p95_ms` the 95th percentile of
the latency of every request in it. Python's cyclic garbage collector is
off for the window, with set-up's objects frozen out of its reach. With
`--trace 1` the first
`trace_calls` requests of the window run under torch.profiler, with a span
around each request (the program records its own spans inside it), and the
line carries the per-layer metrics instead. After the window the program
is freed and every answer is compared with the plain reference
(gpubench/correctness.py).
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gpubench import correctness, load_file, trace, traffic

ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "birdnet_stm32_tpu")
METRICS_DIR = Path(__file__).resolve().parent / "metrics"


class Refused(RuntimeError):
    """A run that prints no result: `code` is its exit code."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return bench, cell, load_config(ROOT / entry["file"]), traffic.load(cell["traffic"])


def load_config(path: Path) -> dict:
    """A configuration's file, which names its `model` (the reference and
    MAC files that gpubench/reference/ and gpubench/yardstick/ find by it)
    and, for a float runner, its `builder`."""
    config = json.loads(path.read_text())
    need = ("model", "builder") if config.get("runner") == "torch" else ("model",)
    missing = [k for k in need if k not in config]
    if missing:
        raise SystemExit(f"{path}: no {' or '.join(map(repr, missing))} key")
    return config


def cell_metrics(bench: dict, cell: dict, kind: str) -> list[dict]:
    """The cell's metrics of a kind ("end_to_end" or "per_layer")."""
    return [m for m in bench[kind] if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_metric(name: str, ctx):
    return load_file(METRICS_DIR, name).read(ctx)


@dataclass
class TraceContext:
    trace: trace.Trace
    calls: int
    rows: int
    cards: int
    config: dict
    window_chunks: int
    window_s: float


def _sync(torch, devices) -> None:
    for d in dict.fromkeys(devices):
        if str(d).startswith("cuda"):
            torch.cuda.synchronize(d)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.split("\n")[0].strip()
        return out or None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
             devices: list | None = None, wrap=None, mix_update: dict | None = None
             ) -> tuple[dict, dict]:
    """(the result line, the checks) of one run. `devices` None means the
    cell's cards, cuda:0 up. The CPU tests pass CPU devices, a smaller mix
    (`mix_update`) and `wrap`, which takes the classifier and the number
    of devices and returns a broken classifier."""
    import torch

    from gpubench import system

    bench, cell, config, mix = load_cell(workload)
    mix.update(mix_update or {})
    cards = mix["cards"]
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{workload} needs {cell['chips']} CUDA device(s); "
                          f"torch sees {torch.cuda.device_count()}", 2)
        devices = [f"cuda:{i}" for i in range(cards)]
    sut = system.build(config, mix, seed, devices, ROOT)
    classify = sut.classify if wrap is None else wrap(sut.classify, len(devices))
    pool = traffic.make_pool(mix, config, seed, devices[0])
    for _ in range(mix["warmup_rounds"]):
        for batch in pool:
            classify(batch)
    _sync(torch, devices)
    # No collector pass inside the window: what set-up made is frozen out of
    # its reach, and the window's arrays are freed by their reference counts.
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = time.perf_counter() - t_start

    order = traffic.request_order(mix, seed)
    answers, served, latency, failed = [], [], [], 0

    def request() -> None:
        nonlocal failed
        i = next(order)
        t0 = time.perf_counter()
        try:
            got = np.asarray(classify(pool[i]))
        except Exception as exc:  # noqa: BLE001 - a failed request is counted, not fatal
            print(f"request {len(answers)} failed: {exc!r}", file=sys.stderr)
            got, failed = None, failed + 1
        latency.append(time.perf_counter() - t0)
        answers.append(got)
        served.append(i)

    start = time.perf_counter()
    deadline = start + seconds
    prof, traced_calls, rest_start = None, 0, start
    if traced:
        from torch.profiler import record_function

        traced_calls = mix["trace_calls"]

        def calls():
            for _ in range(traced_calls):
                with record_function(trace.REQUEST_SPAN):
                    request()
        prof = trace.profile(calls)
        rest_start = time.perf_counter()
    while time.perf_counter() < deadline:
        request()
    end = time.perf_counter()
    _sync(torch, devices)
    gc.enable()
    gc.unfreeze()

    peak = max((torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devices)
                if str(d).startswith("cuda")), default=0)
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found)}", 3)

    weights = sut.weights
    del sut, classify
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    refs = correctness.reference_scores(config, mix, pool, weights, ROOT)
    numbers = correctness.compare(answers, served, refs)
    ok, checks = correctness.verdict(numbers, config["score_gap_limit"])

    rows = mix["rows"]
    metrics = {}
    dev_name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else str(devices[0])
    device = {"platform": "gpu", "kind": dev_name, "count": len(devices),
              "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": len(answers), "failed": failed}
    if traced:
        tr = trace.read(prof)
        del prof
        rest = sum(a is not None for a in answers[traced_calls:])
        ctx = TraceContext(tr, traced_calls, rows, cards, config, rest * rows,
                           end - rest_start)
        for m in cell_metrics(bench, cell, "per_layer"):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t0, t1 = tr.window()
        devs = tr.devices()
        device["busy_s"] = sum(tr.busy_us(d) for d in devs) * 1e-6 / max(cards, len(devs))
        device["window_s"] = (t1 - t0) * 1e-6
        device["power_limit"] = _power_limit()
        line["breakdown"] = trace.breakdown(tr)
    else:
        window_s = end - start
        values = {"chunks_per_s": len([a for a in answers if a is not None]) * rows / window_s,
                  "request_p95_ms": float(np.percentile(np.asarray(latency) * 1e3, 95)),
                  "setup_s": setup_s}
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    line.update(metrics=metrics, device=device)
    line["checks"] = checks
    return line, checks
