"""Spans and counters of a traced run, taken from the benchmark's own
wrappers around the calls into each layer of the port (the program is not
edited): set-up replaces these attributes and `uninstall` puts them back.

- scheduler: rows swept and rows of prompt hydrated by every batched sweep
  (`prefill_chunk_fast_batched`, B x bucket rows) and per-slot chunk
  (`prefill_fast`, bucket rows), with each chunk's positions;
- model step: the host wall of every `_plain_tick` (the tick, the sample
  pack and its read, the emission); CUDA events around every
  `_advance_admission` that ran a chunk; CUDA events around every
  `_moe_ffn_batched` call inside a tick;
- kernels, inside the profiled slice only: the shape and the host bounds
  (`time.time_ns`) of every GEMM launch (`launch_gemm`, in each module that
  calls it), and the start and the writing lanes' cache lengths of every
  tick (`_tick_lanes`); the readers tie each kernel of the trace to these
  by the host time of the API call that launched it (its correlation id),
  so a kernel the profiler lost leaves out only itself;
- host phases (step, admit, admission, tick.forward, sample, sample.read, tick)
  with `time.time_ns` stamps, the clock of the profiler's trace, inside the
  profiled slice only.

The profiler is started and stopped on the scheduler thread (its state is
the thread's own), between two steps, after a synchronize, so the slice
holds exactly the kernels of the steps inside it; a first start and stop
at the first step after `install` initialises it inside the set-up."""

from __future__ import annotations

import time

import torch


class Tracer:
    def __init__(self, max_seq_len: int, activities=None):
        from torch.profiler import ProfilerActivity
        self.window = max_seq_len
        self.activities = activities or [ProfilerActivity.CUDA]
        self.ticks: list[tuple[float, float]] = []
        self.admits: list[tuple[float, object, object]] = []
        self.moe: list[tuple[float, object, object]] = []
        self.chunks: list[tuple[float, int, list]] = []   # (t, rows swept, [(pos0, rows)])
        self.gemms: list[tuple] = []   # (t0 ns, t1 ns, (M, N, K, weight bytes, glu, residual))
        self.lanes: list[tuple[int, list[int]]] = []      # (t ns, cache lengths)
        self.phases: list[tuple[str, int, int]] = []
        self.slice_s: tuple[float, float] | None = None   # perf_counter bounds, when set
        self.slice_ns: list[int] = []                     # time_ns at start and stop
        self.prof = None
        self.profiling = False
        self._saved: list[tuple[object, str, object]] = []
        self._in_tick = False
        self._chunk_ran = False
        self._profiler_ready = False

    # -- the profiled slice ------------------------------------------------
    def set_slice(self, t0: float, t1: float) -> None:
        self.slice_s = (t0, t1)

    def _maybe_profile(self) -> None:
        if not self._profiler_ready:
            # the first start of the profiler initialises CUPTI, which takes
            # seconds: pay it at the first step, inside the load's ramp
            from torch.profiler import profile
            with profile(activities=self.activities):
                torch.cuda.synchronize()
            self._profiler_ready = True
        if self.slice_s is None or len(self.slice_ns) == 2:
            return
        now = time.perf_counter()
        if not self.profiling and now >= self.slice_s[0]:
            from torch.profiler import profile
            torch.cuda.synchronize()
            self.prof = profile(activities=self.activities)
            self.prof.__enter__()
            self.slice_ns.append(time.time_ns())
            self.profiling = True
        elif self.profiling and now >= self.slice_s[1]:
            self.stop()

    def stop(self) -> None:
        if not self.profiling:
            return
        torch.cuda.synchronize()
        self.slice_ns.append(time.time_ns())
        self.profiling = False
        self.prof.__exit__(None, None, None)

    # -- installing --------------------------------------------------------
    def _patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def _phase(self, name: str, orig):
        tr = self

        def run(*a, **k):
            if not tr.profiling:
                return orig(*a, **k)
            t0 = time.time_ns()
            try:
                return orig(*a, **k)
            finally:
                tr.phases.append((name, t0, time.time_ns()))
        return run

    def install(self) -> None:
        from yalm_tpu_torch import scheduler as S
        from yalm_tpu_torch.models import fast as F
        from yalm_tpu_torch.ops.cuda import ffn as FF
        from yalm_tpu_torch.ops.cuda import gemv as G
        tr = self
        Sch = S.Scheduler

        def step(orig):
            def run(sched):
                tr._maybe_profile()
                return orig(sched)
            return tr._phase("step", run)

        def advance(orig):
            def run(sched):
                tr._chunk_ran = False
                t = time.perf_counter()
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                orig(sched)
                if tr._chunk_ran:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    tr.admits.append((t, ev, end))
            return run

        def tick(orig):
            def run(sched, lanes):
                t = time.perf_counter()
                tr._in_tick = True
                try:
                    orig(sched, lanes)
                finally:
                    tr._in_tick = False
                if lanes:
                    tr.ticks.append((t, time.perf_counter()))
            return run

        def sweep(orig):
            def run(cfg, fw, tokens, pos0, valid_len, enable, *a, **k):
                tr._chunk_ran = True
                rows = [(int(p), int(v)) for p, v, e in zip(pos0, valid_len, enable) if e]
                tr.chunks.append((time.perf_counter(), len(tokens) * len(tokens[0]), rows))
                return orig(cfg, fw, tokens, pos0, valid_len, enable, *a, **k)
            return run

        def chunk(orig):
            def run(cfg, fw, tokens, pos0, valid_len, *a, **k):
                tr._chunk_ran = True
                tr.chunks.append((time.perf_counter(), len(tokens), [(int(pos0), int(valid_len))]))
                return orig(cfg, fw, tokens, pos0, valid_len, *a, **k)
            return run

        def moe(orig):
            def run(*a, **k):
                if not tr._in_tick:
                    return orig(*a, **k)
                t = time.perf_counter()
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = orig(*a, **k)
                ev[1].record()
                tr.moe.append((t, *ev))
                return out
            return run

        def lanes(orig):
            def run(cfg, positions, write_mask, device):
                if tr.profiling:
                    w = [1] * len(positions) if write_mask is None else list(write_mask)
                    tr.lanes.append((time.time_ns(), [min(int(p) + 1, tr.window)
                                                      for p, on in zip(positions, w) if on]))
                return orig(cfg, positions, write_mask, device)
            return run

        def gemm(orig):
            def run(count, x, w_all, layer, scale=None, *, expert=None, residual=None,
                    glu_act=None):
                if not tr.profiling:
                    return orig(count, x, w_all, layer, scale, expert=expert,
                                residual=residual, glu_act=glu_act)
                packed = w_all.dtype == torch.uint8
                K = w_all.shape[-1] * (2 if packed else 1)
                N = w_all.shape[-2]
                shape = (int(x.shape[0]), int(N), int(K),
                         N * w_all.shape[-1] * w_all.element_size(),
                         bool(glu_act), residual is not None)
                t0 = time.time_ns()
                try:
                    return orig(count, x, w_all, layer, scale, expert=expert,
                                residual=residual, glu_act=glu_act)
                finally:
                    tr.gemms.append((t0, time.time_ns(), shape))
            return run

        self._patch(Sch, "step", step)
        self._patch(Sch, "_admit", lambda o: self._phase("admit", o))
        self._patch(Sch, "_advance_admission", lambda o: self._phase("admission", advance(o)))
        self._patch(Sch, "_plain_tick", lambda o: self._phase("tick", tick(o)))
        self._patch(Sch, "_pack", lambda o: self._phase("sample", o))
        self._patch(S, "_unpack_sample", lambda o: self._phase("sample.read", o))
        self._patch(S, "decode_step_fast_batched", lambda o: self._phase("tick.forward", o))
        self._patch(S, "prefill_chunk_fast_batched", sweep)
        self._patch(S, "prefill_fast", chunk)
        self._patch(F, "_moe_ffn_batched", moe)
        self._patch(F, "_tick_lanes", lanes)
        for mod in (F, G, FF):
            self._patch(mod, "launch_gemm", gemm)

    # -- reading -------------------------------------------------------------
    def outside_slice(self, t: float) -> bool:
        return self.slice_s is None or not (self.slice_s[0] <= t < self.slice_s[1])

    def device_events(self):
        """The slice's device activities: [(name, start ns, end ns)], their
        correlation ids in the same order, and {correlation id: host start
        ns} of the API calls (runtime or driver) that launched them."""
        if self.prof is None or len(self.slice_ns) != 2:
            return [], [], {}
        from torch.autograd import DeviceType
        events, corr, launched = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            if hasattr(e, "start_ns"):
                t0, dt = e.start_ns(), e.duration_ns()
            else:   # older releases report microseconds
                t0, dt = 1000 * e.start_us(), 1000 * e.duration_us()
            c = e.correlation_id() if hasattr(e, "correlation_id") else 0
            if e.device_type() != DeviceType.CPU:
                events.append((e.name(), t0, t0 + dt))
                corr.append(c)
            elif c:
                launched[c] = min(t0, launched.get(c, t0))
        return events, corr, launched
