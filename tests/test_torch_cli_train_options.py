"""PyTorch port, the `train` verb's modes end to end on the CPU.

On a seeded WAV folder at the JAX tests' tiny config, in process with
`--device cpu`: a base run, then `--mixed_precision` (float32 weights in
the run directory), `--qat` and `--qat --qat_act` (`<run>_qat`: every BN
tensor equal to the base run's, the kernels moved; `serve` reads it),
`--linear_probe` (`<run>_probe`: the backbone bit-identical; `serve` reads
it), `--find_lr` (a suggestion inside the sweep; 12 steps) and `--tune 2`
(`trial_0`, `trial_1`, `best_params.json`).
"""

import json

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu_torch.__main__ import main
from tests.test_torch_cli_train import TINY_ARGS
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import write_wav_folder
from tests.torch_train_fixtures import one_torch_thread  # noqa: F401 (autouse)

warm_up()


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_modes")
    data = write_wav_folder(root / "data")
    run = root / "runs" / "base"
    args = ["train", "--data_path_train", str(data), "--run_dir", str(run),
            "--device", "cpu", *TINY_ARGS]
    assert main(args + ["--epochs", "1"]) == 0
    return root, data, run, args


def _weights(run_dir):
    return torch.load(run_dir / "best/state_dict.pt", weights_only=True)


def _serve(root, data, run_dir, name):
    out = root / f"{name}.txt"
    assert main(["serve", "--model_path", str(run_dir), "--audio_dir", str(data / "a"),
                 "--results_file", str(out), "--once", "--device", "cpu"]) == 0
    scores = np.array([line.split("\t")[1:] for line in out.read_text().splitlines()], float)
    assert scores.shape[0] == 4 and np.isfinite(scores).all()
    return scores


def test_mixed_precision(base, tmp_path):
    root, data, _, args = base
    run = tmp_path / "mixed"
    assert main(args[:4] + [str(run)] + args[5:] + ["--epochs", "1", "--mixed_precision"]) == 0
    w = _weights(run)
    assert {t.dtype for t in w.values() if t.is_floating_point()} == {torch.float32}
    rows = (run / "history.csv").read_text().splitlines()
    assert len(rows) == 2 and np.isfinite(float(rows[1].split(",")[3]))


@pytest.mark.parametrize("act", [[], ["--qat_act"]])
def test_qat(base, act):
    root, data, run, args = base
    assert main(args + ["--epochs", "1", "--qat", "--learning_rate", "1e-3", *act]) == 0
    qat = run.with_name("base_qat")
    for name in ("best/state_dict.pt", "last/train_state.pt", "model_config.json",
                 "labels.txt", "train_state.json", "history.csv"):
        assert (qat / name).exists(), name
    before, after = _weights(run), _weights(qat)
    for k, t in after.items():
        if "_bn." in k:
            assert torch.equal(t, before[k]), k
    assert not torch.equal(after["stem_conv.weight"], before["stem_conv.weight"])
    assert json.loads((qat / "train_state.json").read_text())["multilabel"] is True
    _serve(root, data, qat, "qat")


def test_linear_probe(base):
    root, data, run, args = base
    assert main(args + ["--epochs", "1", "--linear_probe"]) == 0
    probe = run.with_name("base_probe")
    before, after = _weights(run), _weights(probe)
    for k, t in after.items():
        if not k.startswith("pred."):
            assert torch.equal(t.view(torch.int32) if t.is_floating_point() else t,
                               before[k].view(torch.int32) if t.is_floating_point()
                               else before[k]), k
    assert not torch.equal(after["pred.weight"], before["pred.weight"])
    scores = _serve(root, data, probe, "probe")
    np.testing.assert_allclose(scores.sum(1), 1.0, atol=1e-4)  # softmax head: no mixup


def test_find_lr(base, capsys, monkeypatch):
    """The CLI's sweep, cut from 100 steps to 12 (the sweep itself is held
    against JAX in tests/test_torch_train_tools.py)."""
    import functools

    from birdnet_stm32_tpu_torch.training import lr_finder

    monkeypatch.setattr(lr_finder, "run_lr_finder",
                        functools.partial(lr_finder.run_lr_finder, num_steps=12))
    _, _, _, args = base
    assert main(args + ["--find_lr"]) == 0
    line = [s for s in capsys.readouterr().out.splitlines() if "suggested learning rate" in s]
    lr = float(line[-1].rsplit(" ", 1)[1])
    assert 1e-7 <= lr <= 1.0


def test_tune(base, tmp_path):
    _, _, _, args = base
    run = tmp_path / "tune"
    assert main(args[:4] + [str(run)] + args[5:] + ["--tune", "2", "--epochs", "5"]) == 0
    best = json.loads((run / "best_params.json").read_text())
    assert best["trial"] in (0, 1) and "alpha" in best["params"]
    for n in (0, 1):
        assert (run / f"trial_{n}/best/state_dict.pt").exists()
        assert len((run / f"trial_{n}/history.csv").read_text().splitlines()) == 3
