"""One run of one cell: set-up, the measured window, the metrics and the
check that decides `correct`.

Set-up (counted in `setup_s`, from the process's start to the window's
opening): the cell's weights made on the card from the seed, the port's
server with the library loaded from `build/<hash>/`, one pass over each
shape the serving path takes (`Server.warm`), and the load's ramp. The mix's
generator then drives the server for the window. Requests due inside the
window are followed after it closes until their first token, then the
server stops, the peak memory is read, the program's state is freed, and
the reference judges a sample of the greedy requests the window finished.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import stats
from .device import Slice
from .reference import judge
from .routing import RouteLog
from .serve import Server
from .spans import Tracer
from .traffic import Spec, generator
from .weights import synth

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yalm_tpu")   # top-level module names, compared whole
DRAIN_S = 60.0          # how long requests due in the window are followed after it
SLICE_SHARE = 0.25      # the profiled slice: the window's last cell["trace_seconds"],
                        # and at most this share of it


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def reader(name: str):
    """The `read(run)` function of metric `name`, from metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: its end-to-end ones, or with
    trace its per-layer ones. A metric without a `workloads` list belongs to
    every cell (a per-layer one: every cell that reports what it moves)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """What the metric readers see of a finished run."""

    def __init__(self, cfg, cell, mix, seconds, t_start):
        self.cfg, self.cell, self.mix, self.seconds = cfg, cell, mix, seconds
        self.t_start = t_start
        self.records = []
        self.w0 = self.w1 = None
        self.tracer: Tracer | None = None
        self.slice: Slice | None = None

    @property
    def setup_s(self) -> float:
        return self.w0 - self.t_start

    def in_window(self, t: float) -> bool:
        return stats.inside(t, self.w0, self.w1)

    def untraced(self, t: float) -> bool:
        """Inside the window and outside the profiled slice, whose host
        times the profiler stretches."""
        return self.in_window(t) and (self.tracer is None or self.tracer.outside_slice(t))


def describe(run: Run, log) -> None:
    """The window's gap and TTFT distributions and the profiled slice's
    extent, on standard error, beside the metrics."""
    def q(v, scale=1.0):
        return " ".join(f"p{p} {scale * stats.percentile(v, p):.4g}" for p in (50, 80, 90, 95, 99))
    gaps = stats.gaps_in((r.times for r in run.records), run.w0, run.w1)
    if gaps:
        med = stats.percentile(gaps, 50)
        log(f"token gaps in the window: n {len(gaps)}, ms {q(gaps, 1e3)}; "
            f"over 3x the median: {sum(g > 3 * med for g in gaps) / len(gaps):.2%}")
    held = held_tokens(run)
    if held:
        c = run.cfg
        per_tok = (4 * c["num_hidden_layers"] * c["num_key_value_heads"]
                   * c["hidden_size"] // c["num_attention_heads"])
        log(f"KV the traffic holds in the window: mean {sum(held) / len(held):.0f} tokens, "
            f"most {max(held)} ({max(held) * per_tok / 1e9:.2f} GB in bf16) of "
            f"{run.cell['batch'] * c['max_position_embeddings']} reserved")
    tt = stats.ttfts(((r.due, r.first, r.failed) for r in run.records), run.w0, run.w1)
    if tt:
        log(f"TTFT of requests due in the window: n {len(tt)}, s {q(tt)}")
    if run.slice is not None and run.slice.events:
        ev = run.slice.events
        log(f"profiled slice {run.slice.window_s:.3f} s: {len(ev)} device events from "
            f"{(min(a for _, a, _ in ev) - run.slice.t0) / 1e6:.3f} ms to "
            f"{(max(b for _, _, b in ev) - run.slice.t0) / 1e6:.3f} ms")


def held_tokens(run: Run, points: int = 64) -> list[int]:
    """The cache positions the requests in flight hold (prompt and tokens
    delivered so far), at `points` even times of the window."""
    out = []
    for i in range(points):
        t = run.w0 + (i + 0.5) * (run.w1 - run.w0) / points
        out.append(sum(len(r.spec.prompt) + bisect.bisect_right(r.times, t) for r in run.records
                       if r.submit <= t and (r.finished is None or r.finished > t)))
    return out


def files(workload: str) -> dict:
    """What a run of `workload` reads: BENCHMARK.json, its entry there, and
    the cell's, the configuration's and the mix's files, found by name."""
    bench = load(ROOT / "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    return dict(bench=bench, wl=wl, cell=load(HERE / "cells" / f"{workload}.json"),
                cfg=load(HERE / "configs" / f"{wl['config']}.json"),
                mix=load(HERE / "traffic" / f"{wl['traffic']}.json"))


def execute(workload: str, seed: int, seconds: float, trace: bool, t_start: float, *,
            device="cuda", given: dict | None = None, control: bool = False,
            log=print) -> dict:
    """One run; returns the result line's fields, and under "extra" what
    the calibration and the tests read (the gaps; with control, the
    control's gaps and its verdict by the same checks).
    given: the run's files (`files(workload)` if None)."""
    f = given or files(workload)
    bench, wl, cell, cfg, mix = f["bench"], f["wl"], f["cell"], f["cfg"], f["mix"]
    run = Run(cfg, cell, mix, seconds, t_start)
    cuda = torch.device(device).type == "cuda"
    from yalm_tpu_torch.ops.cuda import _build

    marks = [("start", t_start), ("imports", time.perf_counter())]
    weights = synth(cfg, device, seed)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    server = Server(cfg, weights, cell["batch"], device)
    marks.append(("server", time.perf_counter()))
    samp = mix.get("sampled", {})
    server.warm((samp.get("temperature", 1.0), samp.get("top_p", 1.0), samp.get("top_k", 0)))
    marks.append(("warm-up", time.perf_counter()))
    routes_on = bool(cfg.get("num_local_experts"))
    routes = RouteLog(server.engine.sched) if routes_on else None
    if routes is not None:
        routes.install()
    if trace:
        run.tracer = Tracer(cfg["max_position_embeddings"])
        run.tracer.install()
        span = min(float(cell["trace_seconds"]), SLICE_SHARE * seconds)
        server.on_open = lambda t: run.tracer.set_slice(t + seconds - span, t + seconds)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        generator(mix["kind"]).drive(mix, seed, server, seconds)
        run.w0, run.w1 = server.w0, server.w1
        marks.append(("ramp", run.w0))
        log(f"host: {len(os.sched_getaffinity(0))} cores to this process, "
            f"{torch.get_num_threads()} torch threads")
        log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
            + (f"; kernel library built in {max(_build.BUILD_SECONDS.values()):.1f} s"
               if _build.BUILD_SECONDS else "; kernel library found built"))
        due = [r for r in server.records if run.in_window(r.due)]
        if not server.wait_until(lambda: all(r.first is not None or r.failed for r in due),
                                 DRAIN_S):
            log(f"drain: {sum(r.first is None for r in due)} requests due in the window had "
                f"no token {DRAIN_S} s after it")
        if run.tracer is not None and len(run.tracer.slice_ns) != 2:
            # the slice ends at a step of the scheduler thread: make sure one runs
            server.submit(Spec(prompt=[server.bos, 3], max_new_tokens=1), server.now())
            if not server.wait_until(lambda: len(run.tracer.slice_ns) == 2, 60.0):
                log("trace: the profiled slice did not end; the trace is left out")
    finally:
        server.close()
        if run.tracer is not None:
            run.tracer.uninstall()
        if routes is not None:
            routes.uninstall()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.records = server.records
    if run.tracer is not None and len(run.tracer.slice_ns) == 2:
        events, corr, launched = run.tracer.device_events()
        run.slice = Slice(events, *run.tracer.slice_ns, run.tracer.phases, corr, launched)
        if not run.slice.events:
            log("trace: the profiler recorded no device activity in the slice; the metrics "
                "read from the trace are left out")
        run.tracer.prof = None

    values = {}
    for m in cell_metrics(bench, workload, trace):
        v = reader(m["name"])(run)
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run; left out")
        else:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    describe(run, log)
    in_win = [r for r in run.records
              if run.in_window(r.due) or any(run.in_window(t) for t in r.times)]
    failed = sum(1 for r in in_win if r.failed or (run.in_window(r.due) and r.first is None))
    limit = cell["check"]
    served = [r for r in run.records
              if r.spec.greedy and r.finished is not None and r.finished >= run.w0
              and not r.failed and r.client is not None]
    picked = judge.choose([(r.client, len(r.req.generated)) for r in served], seed,
                          int(limit["tokens"]), int(limit["requests"]), int(limit["prefix"]))
    served = [served[i] for i, _ in picked]
    sample = [(list(r.spec.prompt), list(r.req.generated[:k])) for r, (_, k) in zip(served, picked)]
    given = None
    if routes is not None:
        L, k = cfg["num_hidden_layers"], cfg["num_experts_per_tok"]
        given = [routes.routes(r.req, len(p) + len(s) - 1, L, k)
                 for r, (p, s) in zip(served, sample)]
    late = [r.submit - r.due for r in run.records if run.in_window(r.due)]
    backlog = sum(1 for r in run.records if run.in_window(r.due)
                  and (r.first is None or r.first >= run.w1))
    result = {"correct": False, "attempted": len(in_win), "failed": failed, "metrics": values}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if trace and run.slice is not None:
        dev["busy_s"] = run.slice.busy_s()
        dev["window_s"] = run.slice.window_s
        result["breakdown"] = {"device_ops": run.slice.top_ops(),
                               "idle_gaps": run.slice.idle_by_phase()}
    result["device"] = dev

    # the program's state goes before the reference runs
    del server, run.tracer, routes, served
    run.records = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    gaps, readings = judge.served_gaps(cfg, weights, sample, given) if sample else ([], {})
    extra = {"gaps": gaps, "routes": readings, "sample_requests": len(sample),
             "backlog": backlog, "reference_s": time.perf_counter() - t_ref,
             "sender_late_s": stats.percentile(late, 99) if late else None}
    n_tok = sum(len(s) for _, s in sample)
    checks = judge.checks(gaps, readings, n_tok, failed, limit, routes_on)
    if control and sample:
        extra["control_gaps"], extra["control_routes"] = judge.control_gaps(cfg, weights, sample)
        extra["control_checks"] = judge.checks(extra["control_gaps"], extra["control_routes"],
                                               n_tok, failed, limit, routes_on)
        extra["control_correct"] = judge.correct(extra["control_checks"])
    result["correct"] = judge.correct(checks)
    result["load"] = {"sender_late_p99_s": extra["sender_late_s"], "requests": len(in_win)}
    result["checks"] = checks
    result["extra"] = extra
    return result
