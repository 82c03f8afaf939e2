"""CLI dispatch: python -m birdnet_stm32_tpu_torch <command> [args].

The port's verbs: `serve`, `train`, `evaluate`, `benchmark`, `board-test`,
`profile`, `convert` and `deploy`, each on CUDA by default (`--device cpu`
for the CPU; `profile` is analytical and runs nowhere). `convert` needs
TensorFlow for its TFLite export and exits with code 2 where it cannot be
imported; `convert --stablehlo` and `deploy --stablehlo` exit with code 2
(ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import sys

COMMANDS = {
    "serve": ("birdnet_stm32_tpu_torch.cli.serve",
              "Watch a directory, classify new WAVs continuously"),
    "train": ("birdnet_stm32_tpu_torch.cli.train",
              "Train a DS-CNN on a folder of class-labelled WAVs"),
    "evaluate": ("birdnet_stm32_tpu_torch.cli.evaluate",
                 "Pooled file-level metrics and reports on a labelled test set"),
    "benchmark": ("birdnet_stm32_tpu_torch.cli.benchmark",
                  "Batched inference over a WAV directory with [BENCH] timings"),
    "board-test": ("birdnet_stm32_tpu_torch.cli.board_test",
                   "The board test's loop on the local device, from a deploy config"),
    "profile": ("birdnet_stm32_tpu_torch.cli.profile",
                "Analytical per-layer parameters, MACs and activation bytes"),
    "convert": ("birdnet_stm32_tpu_torch.cli.convert",
                "Run directory -> INT8 TFLite with the cosine gate (needs TensorFlow)"),
    "deploy": ("birdnet_stm32_tpu_torch.cli.deploy",
               "Package a model, sidecars and firmware headers into a bundle"),
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m birdnet_stm32_tpu_torch <command> [args]\n\ncommands:")
        for name, (_, doc) in COMMANDS.items():
            print(f"  {name:<10} {doc}")
        return 0 if argv else 2
    cmd = argv[0].replace("_", "-")
    if cmd not in COMMANDS:
        print(f"command {argv[0]!r} is unknown (expected one of {', '.join(COMMANDS)})",
              file=sys.stderr)
        return 2
    import importlib

    return int(importlib.import_module(COMMANDS[cmd][0]).main(argv[1:]) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
