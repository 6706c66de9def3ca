"""Readings for the limits of ``correct``, on the chip, in one process:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--seconds 3]

For every seed, one run of the cell (``run.run_cell``) with a short window:
the program's numbers against the reference (the lower readings). For each
control seed, also each control of ``run.CONTROLS`` in the program's place
on the same samples (the upper readings). One JSON line a seed, then a
summary: each number's largest program reading and, by control, its
smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("REALSR_TPU")]:
        del os.environ[k]
    os.environ["REALSR_TPU_TORCH_BUILD"] = os.path.join(run.BENCH, "_build")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    seeds += sorted(controls - set(seeds))
    lower, upper = {}, {}
    for seed in seeds:
        r = run.run_cell(args.workload, seed, args.seconds, False, control=seed in controls)
        line = {"seed": seed, "correct": r["correct"], "program": {k: v["value"] for k, v in r["check"].items()}}
        for k, v in line["program"].items():
            if v is not None:
                lower[k] = max(lower.get(k, v), v)
        if "control" in r:
            line["control"] = r["control"]
            for name, numbers in r["control"].items():
                got = upper.setdefault(name, {})
                for k, v in (numbers or {}).items():
                    got[k] = min(got.get(k, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper, "seeds": len(seeds),
                      "control_seeds": len(controls)}), flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"control: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
