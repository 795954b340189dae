#!/usr/bin/env python3
"""The readings that a cell's limit on `gap_max` is set from, on the card:

    python3 h100bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,... [--control-seeds 1,2,3]

One process runs the cell once per seed, as `run.py` does (weights from the
seed, the server, the warm-up, the load, the window, the sample, the
reference), and prints one JSON line per seed: the program's `gap_max` (the
lower reading is the largest over a dozen seeds or more) and, on the
control seeds, the control's: the reference computed with float8-e4m3
operands in the program's place, the gap of the token it ranks first at
each position of the same sample (the upper reading is the smallest), and
`control_correct`, the harness's verdict with the control's gaps in the
program's place (false where the limit separates the two). The
benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from h100bench.harness import execute
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = execute(args.workload, seed, args.seconds, False, t0, control=seed in control,
                      log=lambda m: print(m, file=sys.stderr, flush=True))
        ex = res["extra"]
        line = {"workload": args.workload, "seed": seed, "correct": res["correct"],
                "gap_max": max(ex["gaps"]) if ex["gaps"] else None,
                **ex["routes"],
                "tokens": len(ex["gaps"]), "requests": ex["sample_requests"],
                "reference_s": ex["reference_s"], "metrics": res["metrics"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        if "control_gaps" in ex:
            line["control_gap_max"] = max(ex["control_gaps"])
            line.update({f"control_{k}": v for k, v in ex["control_routes"].items()})
            line["control_correct"] = ex["control_correct"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
