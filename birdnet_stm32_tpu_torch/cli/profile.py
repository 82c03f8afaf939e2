"""Profile CLI: the analytical per-layer cost table of a config or a run
directory (port of cli/profile.py; models/profiler.py).

    python -m birdnet_stm32_tpu_torch profile --config_path model_config.json
"""

from __future__ import annotations

import argparse
from pathlib import Path


def get_args(argv=None):
    p = argparse.ArgumentParser("birdnet_stm32_tpu_torch profile")
    p.add_argument("--config_path", default=None, help="model_config.json")
    p.add_argument("--model_path", default=None, help="checkpoint dir (uses its config)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)

    from birdnet_stm32_tpu_torch.config import ModelConfig
    from birdnet_stm32_tpu_torch.models.profiler import check_n6_compatibility, print_profile

    if args.config_path:
        cfg = ModelConfig.load(args.config_path)
    elif args.model_path:
        mp = Path(args.model_path)
        if mp.suffix == ".keras":
            # The .keras -> run directory / sidecar mapping of train and
            # evaluate.
            from birdnet_stm32_tpu_torch.training.checkpoint import keras_run_dir

            run = keras_run_dir(mp)
            sidecar = mp.with_name(mp.stem + "_model_config.json")
            if run is not None:
                mp = run
            elif sidecar.exists():
                cfg = ModelConfig.load(sidecar)
                print_profile(cfg)
                for w in check_n6_compatibility(cfg):
                    print(f"[warn] {w}")
                return 0
        cfg = ModelConfig.load(Path(mp) / "model_config.json")
    else:
        raise SystemExit("need --config_path or --model_path")

    print_profile(cfg)
    for w in check_n6_compatibility(cfg):
        print(f"[warn] {w}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
