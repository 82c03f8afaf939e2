"""A whole run of a cell on the CPU (the look for a card skipped, a
smaller mix), with the timed path broken underneath: each fault a serving
cell can have has to turn `correct` false. The exchange between cards is
broken on the INT8 cell spread over four CPU devices, the mesh path of
`closed-b256-int16-mesh4`. The card machine runs the same harness on the
cards."""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest
import torch

from gpubench import harness

SMALL = {"rows": 4, "pool": 2, "warmup_rounds": 1, "trace_calls": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def altered_answer(classify, n_devices):
    """One row's scores come back in reverse class order."""
    def broken(x):
        out = np.array(classify(x))
        out[0] = out[0, ::-1]
        return out
    return broken


def half_batch(classify, n_devices):
    """The second half of the rows is left out: each gets the mean of the first half."""
    def broken(x):
        out = np.array(classify(x))
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(axis=0)
        return out
    return broken


def stale_answer(classify, n_devices):
    """Each request gets the answer of the request before it."""
    last = []

    def broken(x):
        out = np.array(classify(x))
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return broken


def no_exchange(classify, n_devices):
    """The scores of every card but the first are never gathered: the
    first card's block stands in for each."""
    def broken(x):
        out = np.array(classify(x))
        block = out.shape[0] // n_devices
        for k in range(1, n_devices):
            out[k * block:(k + 1) * block] = out[:block]
        return out
    return broken


CASES = [("int8-b64-int16", 1, altered_answer), ("int8-b64-int16", 1, half_batch),
         ("int8-b64-int16", 1, stale_answer), ("bf16-b64-int16", 1, altered_answer),
         ("bf16-b64-int16", 1, half_batch), ("bf16-b64-f32-48k", 1, stale_answer),
         ("int8-b64-int16", 4, no_exchange)]


def run(workload, cards, wrap=None, traced=False):
    return harness.run_cell(workload, 2**31 + 17, 0.3, traced, time.perf_counter(),
                            devices=["cpu"] * cards, wrap=wrap,
                            mix_update={**SMALL, "rows": SMALL["rows"] * cards,
                                        "cards": cards})


@pytest.mark.parametrize("workload,cards,fault", CASES,
                         ids=[f"{w}-{f.__name__}" for w, _, f in CASES])
def test_fault_turns_correct_false(workload, cards, fault):
    sound, sound_checks = run(workload, cards)
    broken, checks = run(workload, cards, fault)
    assert sound_checks["unanswered"]["value"] == sound_checks["malformed"]["value"] == 0
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"]
    assert checks["score_gap"]["value"] > 4 * sound_checks["score_gap"]["value"]
    assert broken["correct"] is False


def test_a_request_that_raises_is_counted_and_fails_the_run():
    def raising(classify, n_devices):
        calls = []

        def broken(x):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("lost request")
            return classify(x)
        return broken

    line, checks = run("int8-b64-int16", 1, raising)
    assert line["failed"] == 1 and checks["unanswered"]["value"] == 1
    assert line["correct"] is False


def test_traced_run_on_the_cpu_keeps_the_line_shape():
    line, _ = run("bf16-b64-int16", 1, traced=True)
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_a_loaded_jax_module_refuses_the_run(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    with pytest.raises(harness.Refused) as info:
        run("int8-b64-int16", 1)
    assert info.value.code == 3 and "flax" in str(info.value)
