"""The arithmetic behind the per-layer metrics, shared by the readers in
`metrics/` (readers of one quantity in cells that move different
end-to-end metrics share a function here). Each function takes the finished run (`harness.Run`) and
returns a number, or None where the run holds nothing to read."""

from __future__ import annotations

import statistics
import sys

from . import flops, stats
from .device import GEMM, LANES


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sweep_row_use(run):
    """Prompt rows hydrated over rows swept, in %, over every batched sweep
    (B x bucket rows) and per-slot chunk (bucket rows) of the window."""
    swept = useful = 0
    for t, rows, parts in run.tracer.chunks:
        if run.in_window(t):
            swept += rows
            useful += sum(n for _, n in parts)
    return 100.0 * useful / swept if swept else None


def tick_ms(run):
    """Mean host wall of a tick (`_plain_tick`) in the window."""
    walls = [b - a for a, b in run.tracer.ticks if run.untraced(a)]
    return 1e3 * statistics.fmean(walls) if walls else None


def admit_ms(run):
    """Mean device span (CUDA events) of an admission step that ran a chunk."""
    ms = [a.elapsed_time(b) for t, a, b in run.tracer.admits if run.untraced(t)]
    return statistics.fmean(ms) if ms else None


def moe_ffn_ms_per_tick(run):
    """CUDA-event time of the ticks' MoE FFN calls over the ticks."""
    ticks = sum(1 for a, _ in run.tracer.ticks if run.untraced(a))
    calls = [a.elapsed_time(b) for t, a, b in run.tracer.moe if run.untraced(t)]
    return sum(calls) / ticks if ticks and calls else None


def _traced(run):
    return run.slice is not None and run.slice.events


def gemm_roofline(run):
    """Sum of the GEMM launches' bounds over their kernels' summed device
    time, in %, over the profiled slice: each `gemm_kernel` of the trace
    is tied by its launch's host time to the `launch_gemm` call it came
    from, and a call with no kernel in the trace (the profiler loses a few
    in some slices) counts on neither side."""
    if not _traced(run):
        return None
    launches = run.tracer.gemms
    found = run.slice.by_span(GEMM, [(a, b) for a, b, _ in launches])
    kept = {i: ev for i, ev in found.items() if len(ev) == 1}
    n = run.slice.count(GEMM)
    if len(kept) != len(launches) or len(kept) != n:
        _say(f"gemm_roofline: {len(kept)} of {len(launches)} launches tied to one of the "
             f"trace's {n} gemm_kernel events")
    if not kept:
        return None
    bound = sum(flops.bound_s(*flops.gemm_counts(M, N, K, wb / (N * K), glu, res))
                for M, N, K, wb, glu, res in (launches[i][2] for i in kept))
    busy = sum(b - a for ev in kept.values() for a, b in ev) / 1e9
    return 100.0 * bound / busy


def attn_roofline(run):
    """Sum of the tick attention calls' bounds (the writing lanes' cache
    lengths, every layer) over the union of the lanes split's two kernels,
    in %, over the profiled ticks whose 2 x layers kernels the trace holds
    whole (each tied by its launch's host time to the tick it came from)."""
    if not _traced(run):
        return None
    cfg = run.cfg
    L = cfg["num_hidden_layers"]
    ticks = run.tracer.lanes
    ends = [t for t, _ in ticks[1:]] + [run.slice.t1]
    found = run.slice.by_span(LANES, [(t, e) for (t, _), e in zip(ticks, ends)])
    kept = [i for i, ev in found.items() if len(ev) == 2 * L]
    if len(kept) != len(ticks):
        _say(f"attn_roofline: {len(kept)} of {len(ticks)} ticks hold their {2 * L} lanes-split "
             f"kernels in the trace ({run.slice.count(LANES)} in all)")
    if not kept:
        return None
    hq, hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // hq
    bound = L * sum(flops.bound_s(*flops.attn_counts(ticks[i][1], hq, hk, hd, 2)) for i in kept)
    busy = stats.union_length(iv for i in kept for iv in found[i]) / 1e9
    return 100.0 * bound / busy


def idle_share(run):
    """1 - device busy (union of activity intervals) / slice, in %."""
    if not _traced(run):
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.window_s)


def mfu_window(run):
    """Model operations of every token processed in the window -- prompt
    rows hydrated by its chunks and tokens decoded by its ticks, routed
    experts only, attention over each token's context -- over the window's
    seconds at the bf16 peak, in %."""
    cfg = run.cfg
    per_tok = 2.0 * flops.matmul_params_per_token(cfg)
    hq = cfg["num_attention_heads"]
    per_ctx = 4.0 * hq * (cfg["hidden_size"] // hq) * cfg["num_hidden_layers"]
    total = 0.0
    for t, _, parts in run.tracer.chunks:
        if run.in_window(t):
            for p0, n in parts:
                total += per_tok * n + per_ctx * (n * p0 + n * (n + 1) / 2)
    for r in run.records:
        plen = len(r.spec.prompt)
        for j, t in enumerate(r.times):
            if j and run.in_window(t):
                total += flops.token_flops(cfg, plen + j)
    return 100.0 * total / ((run.w1 - run.w0) * flops.PEAK_BF16_FLOPS) if total else None
