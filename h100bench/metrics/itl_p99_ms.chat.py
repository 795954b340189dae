"""itl_p99_ms.chat: the 99th percentile of every gap between consecutive
tokens of every request, both ends inside the window and outside the
profiled slice, whose host times the profiler stretches (host clock)."""

from h100bench import stats


def read(run):
    gaps = [b - a for r in run.records for a, b in zip(r.times, r.times[1:])
            if run.untraced(a) and run.untraced(b)]
    return 1e3 * stats.percentile(gaps, 99) if gaps else None
