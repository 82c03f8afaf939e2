"""Run one benchmark cell once and print its result as the last line.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json, gpubench/ and
the port (birdnet_stm32_tpu_torch). Exits 2 without a result when CUDA is
missing or the cell needs more cards than torch sees, and 3 when JAX or the
JAX package was loaded. The numbers compared for `correct` are printed
beside their limits as the last lines on standard error and under the
line's last key, `checks`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpubench import harness

    try:
        line, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), T_START)
    except harness.Refused as exc:
        print(f"gpubench: {exc}", file=sys.stderr)
        return exc.code
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
