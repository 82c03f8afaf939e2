"""Puts the benchmark's own tests (gpubench/tests/) under tier-1 (`pytest
tests/`): each tests/test_torch_gpubench_<name>.py brings the tests of
gpubench/tests/test_gpubench_<name>.py under the wrapper's name. The card
tests among them skip without a CUDA device, as they do in gpubench/tests.

Most wrappers import the tests and their fixtures. tests/conftest.py loads
JAX into every test process, though, and the benchmark's harness refuses
to run in a process that has loaded JAX or the JAX package
(gpubench/harness.py::forbidden_modules), as it must on the card. A
wrapper of tests that run the harness calls `in_fresh_interpreter`
instead: it defines a test of the same name and parameters for each test
of the module, and each passes, fails or skips as its original did in one
pytest run of the module by a fresh interpreter, which loads no JAX."""

from __future__ import annotations

import inspect
import os
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 900
_RESULTS: dict[str, dict[str, tuple[str, str]]] = {}


def _run(path: str) -> dict[str, tuple[str, str]]:
    """{test name with its parameter ids: (outcome, text)} of one run of the
    test file `path` by a fresh interpreter."""
    if path not in _RESULTS:
        with tempfile.TemporaryDirectory() as tmp:
            xml = Path(tmp) / "junit.xml"
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", path, "-q", "-p", "no:cacheprovider",
                 "-p", "no:randomly", "-p", "no:xdist", f"--junitxml={xml}"],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
                text=True, timeout=TIMEOUT_S, check=False)
            if not xml.exists():
                raise RuntimeError(f"pytest {path} wrote no report:\n{proc.stdout[-4000:]}"
                                   f"\n{proc.stderr[-4000:]}")
            results = {}
            for case in ET.parse(xml).iter("testcase"):
                outcome, text = "passed", ""
                for kind in ("failure", "error", "skipped"):
                    node = case.find(kind)
                    if node is not None:
                        outcome = kind
                        text = (node.get("message") or "") + "\n" + (node.text or "")
                        break
                results[case.get("name")] = (outcome, text)
        _RESULTS[path] = results
    return _RESULTS[path]


def _proxy(path: str, fn):
    argnames = [name.strip() for mark in getattr(fn, "pytestmark", [])
                if mark.name == "parametrize"
                for name in (mark.args[0].split(",") if isinstance(mark.args[0], str)
                             else mark.args[0])]

    def test(request, **params):
        outcome, text = _run(path).get(request.node.name, ("missing", "not in the report"))
        if outcome == "skipped":
            pytest.skip(text.strip())
        assert outcome == "passed", f"{request.node.name} ({outcome}):\n{text[-4000:]}"

    test.__name__ = test.__qualname__ = fn.__name__
    test.__doc__ = fn.__doc__
    test.__signature__ = inspect.Signature(
        [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
         for n in ["request", *argnames]])
    test.pytestmark = list(getattr(fn, "pytestmark", []))
    return test


def in_fresh_interpreter(module, namespace: dict) -> None:
    """Define in `namespace` (a wrapper's globals) a test for each test
    function of `module`, which reads its original's outcome."""
    path = str(Path(module.__file__).resolve().relative_to(ROOT))
    for name, fn in vars(module).items():
        if name.startswith("test_") and inspect.isfunction(fn):
            namespace[name] = _proxy(path, fn)
