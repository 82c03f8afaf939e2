"""The benchmark's files, read without running them: what they import,
and that every name BENCHMARK.json gives resolves to its file."""

from __future__ import annotations

import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "gpubench"
FORBIDDEN = {"jax", "jaxlib", "flax", "birdnet_stm32_tpu"}
PORT = "birdnet_stm32_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_imports_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "yardstick", "metrics", "tests/standin"])
def test_reference_and_yardstick_import_no_port(sub):
    for path in sorted((BENCH_DIR / sub).rglob("*.py")):
        assert PORT not in top_level_imports(path), path


def test_the_port_is_imported_by_the_system_module_alone():
    users = {p.relative_to(BENCH_DIR).as_posix() for p in SOURCES
             if PORT in top_level_imports(p) and "tests" not in p.parts}
    assert users == {"system.py"}


def test_names_resolve_to_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        assert w["config"] in configs
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["per_layer"]:
        spec = importlib.util.spec_from_file_location(m["name"],
                                                      BENCH_DIR / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
    model_files = {json.loads((ROOT / c["file"]).read_text()).get("tflite")
                   for c in b["configs"]} - {None}
    for f in model_files:
        assert (ROOT / f).is_file() and f.startswith("gpubench/")


def test_configurations_name_their_model_and_builder():
    from gpubench import load_file, reference, system

    for c in bench()["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        model = config["model"]
        assert callable(reference.model(model).scores), model
        assert callable(load_file(BENCH_DIR / "yardstick", f"macs_{model}").model_macs), model
        if config["runner"] == "torch":
            assert callable(system.builder(config["builder"]))


def test_contract_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["gpubench"]
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "chunks_per_s", "request_p95_ms"} <= e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    assert layers == {"serving entry", "ingress", "frontend kernels", "model", "device"}
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)


def test_traffic_cards_fit_the_cells_chips():
    for w in bench()["workloads"]:
        mix = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        assert mix["cards"] <= w["chips"]
        assert mix["rows"] % mix["cards"] == 0


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", p.relative_to(ROOT).as_posix()), p
