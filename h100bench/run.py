#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (`yalm_tpu_torch`) on NVIDIA H100s.

Run from the root of a checkout:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process per run: it sets up the cell (weights from the seed, the
server, the warm-up, the load's ramp), measures for --seconds, judges the
outputs against the plain reference, and prints one JSON object as the last
line of standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (and a `breakdown` of the profiled slice).
The numbers compared for `correct` are printed beside their limits as the
last lines of standard error and under the result's last key, `checks`.

It exits with another code than 0, and prints no result, when no CUDA card
(or fewer than the cell asks for) is present, when the program cannot be
imported, or when `jax`, `jaxlib`, `flax` or the JAX package `yalm_tpu` is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    chips = int(wl[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2

    from h100bench.harness import execute, forbidden_modules, power_limit_w
    power = power_limit_w()
    res = execute(args.workload, args.seed, args.seconds, bool(args.trace), T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log(f"modules that a run may not load are loaded: {', '.join(bad)}")
        return 3
    extra, checks = res.pop("extra"), res.pop("checks")
    res["card"] = {"power_limit_w": power, "name": res["device"]["kind"]}
    res["checks"] = checks
    log(f"card {res['device']['kind']}, power limit {power} W; "
        f"sample of {extra['sample_requests']} greedy requests")
    for name, c in checks.items():
        rel = ">=" if name == "tokens_checked" else "<="
        log(f"check {name}: {c['value']!r} (limit: {rel} {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
