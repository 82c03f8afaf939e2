"""PyTorch port, the `train` verb end to end on the CPU.

`python -m birdnet_stm32_tpu_torch train --device cpu` (in process) on a
seeded folder of mono PCM16 WAVs at the model rate writes a run directory
(best/, last/, model_config.json, labels.txt, train_state.json,
history.csv); `serve` on that directory writes a TSV with the head
train_state.json records (sigmoid: mixup makes the run multilabel). The
arguments and defaults, build_loaders' file split and
balanced_class_weights equal the JAX package's; the options not ported yet
exit 2; without --device the verb asks for CUDA and raises where there is
none.
"""

import json

import numpy as np
import pytest
import torch

from birdnet_stm32_tpu.cli import train as JT
from birdnet_stm32_tpu_torch.__main__ import main
from birdnet_stm32_tpu_torch.cli import train as PT
from birdnet_stm32_tpu_torch.models.runners import TorchRunner, load_model_runner
from tests.test_torch_cpu_warmup import warm_up
from tests.torch_train_fixtures import write_wav_folder

warm_up()

TINY_ARGS = ["--sample_rate", "4000", "--chunk_duration", "1.0", "--fft_length", "128",
             "--num_mels", "16", "--spec_width", "32", "--alpha", "0.25",
             "--embeddings_size", "32", "--no_se", "--no_inverted_residual",
             "--batch_size", "8", "--steps_per_epoch", "2", "--num_workers", "0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    data = write_wav_folder(root / "data")
    run_dir = root / "runs" / "tiny.keras"  # a reference-style .keras path
    args = ["train", "--data_path_train", str(data), "--run_dir", str(run_dir),
            "--device", "cpu", "--epochs", "2", "--no_mesh", *TINY_ARGS]
    assert main(args) == 0
    assert main(args[:-len(TINY_ARGS)] + ["--epochs", "3", "--resume", *TINY_ARGS]) == 0
    return root, data, root / "runs"


def test_run_directory(trained):
    _, _, run_dir = trained
    for name in ("best/state_dict.pt", "last/train_state.pt", "model_config.json",
                 "labels.txt", "train_state.json", "history.csv",
                 "tiny_model_config.json", "tiny_labels.txt"):
        assert (run_dir / name).exists(), name
    state = json.loads((run_dir / "train_state.json").read_text())
    assert state["epoch"] == 3 and state["multilabel"] is True
    assert (run_dir / "labels.txt").read_text().split() == ["a", "b", "c"]
    rows = (run_dir / "history.csv").read_text().splitlines()
    assert rows[0].split(",") == ["epoch", "data_wait_s", "dispatch_s", "loss", "seconds",
                                  "val_loss", "val_roc_auc", "val_s"]
    assert len(rows) == 4
    last = torch.load(run_dir / "last/train_state.pt", weights_only=True)
    assert last["step"] == 6 and last["generator"] is not None


def test_serve_the_run_directory(trained):
    root, data, run_dir = trained
    results = root / "served.txt"
    assert main(["serve", "--model_path", str(run_dir), "--audio_dir", str(data / "a"),
                 "--results_file", str(results), "--once", "--device", "cpu"]) == 0
    rows = [line.split("\t") for line in results.read_text().splitlines()]
    assert len(rows) == 4
    scores = np.array([r[1:] for r in rows], float)
    assert scores.shape == (4, 3) and ((scores >= 0) & (scores <= 1)).all()
    for path in (run_dir, run_dir / "tiny.keras"):
        runner = load_model_runner(path, device="cpu")
        assert isinstance(runner, TorchRunner) and runner.model.class_activation == "sigmoid"
    bf16 = load_model_runner(run_dir, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for p in bf16.model.parameters()} == {torch.bfloat16}


def test_args_and_defaults_match_jax(tmp_path):
    argv = ["--data_path_train", str(tmp_path), "--mixup_alpha", "0.3", "--no_mixup",
            "--train_feed", "ulaw", "--tune"]
    got, ref = vars(PT.get_args(argv)), vars(JT.get_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref


def test_loaders_and_class_weights_match_jax(tmp_path):
    data = write_wav_folder(tmp_path / "data", files_per_class=5, seed=3)
    args = PT.get_args(["--data_path_train", str(data), "--sample_rate", "4000",
                        "--chunk_duration", "1.0", "--upsample_ratio", "0.9"])
    for ship in ("int16", "float32"):
        got, ref = PT.build_loaders(args, ship=ship), JT.build_loaders(args, ship=ship)
        for loader, jloader in zip(got[:2], ref[:2]):
            assert loader.paths == jloader.paths
            np.testing.assert_array_equal(loader.labels, jloader.labels)
            assert loader.cfg.ship_int16 == jloader.cfg.ship_int16 == (
                ship == "int16" and loader.shuffle)
        assert got[2:] == ref[2:]
    np.testing.assert_array_equal(PT.balanced_class_weights(got[3], got[2]),
                                  JT.balanced_class_weights(ref[3], ref[2]))


@pytest.mark.parametrize("flag", [["--qat"], ["--qat_act"], ["--linear_probe"], ["--find_lr"],
                                  ["--tune"], ["--tune", "3"], ["--mixed_precision"]])
def test_unported_options_exit_2(flag, tmp_path, capsys):
    assert main(["train", "--data_path_train", str(tmp_path), *flag]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP" in err


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid here")
    data = write_wav_folder(tmp_path / "data", files_per_class=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "--data_path_train", str(data), "--run_dir", str(tmp_path / "r")])


def test_loss_override_and_weights_only_resume(tmp_path):
    """--no_mixup keeps the softmax head (multilabel False); --loss focal
    replaces the loss; --resume_weights_only restarts the optimizer, so the
    resumed run's state counts only its own steps."""
    data = write_wav_folder(tmp_path / "data", files_per_class=3, seed=4)
    args = ["train", "--data_path_train", str(data), "--run_dir", str(tmp_path / "run"),
            "--device", "cpu", "--no_mixup", "--loss", "focal", "--optimizer", "sgd",
            *TINY_ARGS]
    assert main(args + ["--epochs", "1"]) == 0
    state = json.loads((tmp_path / "run/train_state.json").read_text())
    assert state["multilabel"] is False
    assert main(args + ["--epochs", "2", "--resume", "--resume_weights_only"]) == 0
    last = torch.load(tmp_path / "run/last/train_state.pt", weights_only=True)
    assert last["step"] == 2 and "trace" in last["opt_state"]
    assert load_model_runner(tmp_path / "run", device="cpu").model.class_activation == "softmax"
