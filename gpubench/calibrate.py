"""The readings a cell's `score_gap` limit is set from, in one process:
for each seed, one short run of the cell through the harness (the program,
at the cell's own sizes, every answer compared with the reference), and
the control, the reference at the precision below the configuration's put
in the program's place, on the same inputs and weights. The benchmark's
own runs never run this.

    python3 -m gpubench.calibrate --workload <name> --seeds 1 2 3 ... [--seconds 2]

Prints one JSON line per seed: the program's numbers and verdict, and the
control's, each through the harness's own comparison (correctness.compare
and correctness.verdict) against the configuration's limit, at the cell's
own rows.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control_seeds", type=int, default=None,
                   help="run the control on the first N seeds only (default all)")
    args = p.parse_args(argv)

    import torch

    from gpubench import correctness, harness, system, traffic

    _, cell, config, mix = harness.load_cell(args.workload)
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        line, checks = harness.run_cell(args.workload, seed, args.seconds, False, t0)
        out = {"workload": args.workload, "seed": seed, "correct": line["correct"],
               "program_score_gap": checks["score_gap"]["value"],
               "unanswered": checks["unanswered"]["value"],
               "malformed": checks["malformed"]["value"],
               "attempted": line["attempted"],
               "chunks_per_s": line["metrics"].get("chunks_per_s", {}).get("value")}
        if k < n_control:
            pool = traffic.make_pool(mix, config, seed, "cuda:0")
            weights = None
            if config["runner"] == "torch":
                weights = system.build(config, mix, seed, ["cuda:0"], harness.ROOT).weights
            refs = correctness.reference_scores(config, mix, pool, weights, harness.ROOT)
            ctl = correctness.reference_scores(config, mix, pool, weights, harness.ROOT,
                                               control=True)
            ok, ctl_checks = correctness.verdict(
                correctness.compare(ctl, range(len(pool)), refs), config["score_gap_limit"])
            out["control_correct"] = ok
            out["control_score_gap"] = ctl_checks["score_gap"]["value"]
            out["control_rows"] = sum(c.shape[0] for c in ctl)
            torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
