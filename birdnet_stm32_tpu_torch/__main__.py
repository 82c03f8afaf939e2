"""CLI dispatch: python -m birdnet_stm32_tpu_torch <command> [args].

The port's verbs so far: `serve` and `train`. The JAX package's other
verbs are not ported yet (ROADMAP.md) and exit with code 2.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "serve": ("birdnet_stm32_tpu_torch.cli.serve",
              "Watch a directory, classify new WAVs continuously"),
    "train": ("birdnet_stm32_tpu_torch.cli.train",
              "Train a DS-CNN on a folder of class-labelled WAVs"),
}
NOT_PORTED = ("convert", "evaluate", "benchmark", "profile", "deploy", "board-test")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m birdnet_stm32_tpu_torch <command> [args]\n\ncommands:")
        for name, (_, doc) in COMMANDS.items():
            print(f"  {name:<10} {doc}")
        return 0 if argv else 2
    cmd = argv[0].replace("_", "-")
    if cmd not in COMMANDS:
        what = ("is not ported yet" if cmd in NOT_PORTED
                else f"is unknown (expected one of {', '.join(COMMANDS)})")
        print(f"command {argv[0]!r} {what}", file=sys.stderr)
        return 2
    import importlib

    return int(importlib.import_module(COMMANDS[cmd][0]).main(argv[1:]) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
