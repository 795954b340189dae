"""The profiled slice of a traced run, read from the profiler's device
activities (kernels, copies, sets): busy time as the union of their
intervals, time by kernel name, and the idle gaps by the host phase the
scheduler thread was in (after `chip_smoke.py:device_us`,
`device_busy_us`). Times are nanoseconds on the trace's clock."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from . import stats

GEMM = re.compile(r"\bgemm_kernel\b")
LANES = re.compile(r"\blanes_(scores|values)_kernel\b")
NAME_CHARS = 120


class Slice:
    def __init__(self, events: list[tuple[str, int, int]], t0_ns: int, t1_ns: int,
                 phases: list[tuple[str, int, int]], corr: list[int] | None = None,
                 launched: dict[int, int] | None = None):
        self.events, self.t0, self.t1, self.phases = events, t0_ns, t1_ns, phases
        self.corr = corr or [0] * len(events)     # each event's correlation id
        self.launched = launched or {}            # correlation id -> host ns of its launch

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self, pattern=None) -> float:
        """Seconds in which an activity (matching `pattern`, if given) ran."""
        return stats.union_length((a, b) for n, a, b in self.events
                                  if pattern is None or pattern.search(n)) / 1e9

    def count(self, pattern) -> int:
        return sum(1 for n, _, _ in self.events if pattern.search(n))

    def by_span(self, pattern, spans: list[tuple[int, int]]) -> dict[int, list[tuple[int, int]]]:
        """The events matching `pattern` whose launch (host ns, by
        correlation id) lies in span i of `spans` (sorted, disjoint [start,
        end]), as {i: [(start, end), ...]}. An event whose launch the trace
        does not hold, or that lies in no span, is in none."""
        starts = [a for a, _ in spans]
        out = defaultdict(list)
        for (name, a, b), c in zip(self.events, self.corr):
            t = self.launched.get(c)
            if t is None or not pattern.search(name):
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out[i].append((a, b))
        return out

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        by = defaultdict(int)
        for name, a, b in self.events:
            by[name[:NAME_CHARS]] += b - a
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_phase(self, n: int = 10) -> list[list]:
        """Idle device time of the slice by what the host was doing at the
        middle of each gap: the innermost host phase covering it, or
        "server loop" outside every scheduler step. [phase, seconds],
        longest first."""
        phases = sorted(self.phases, key=lambda p: p[1])
        starts = [p[1] for p in phases]
        by = defaultdict(int)
        for a, b in stats.gaps_between([(x, y) for _, x, y in self.events], self.t0, self.t1):
            mid, where = (a + b) / 2, "server loop"
            # walking back from the latest start, the first phase covering
            # mid is the innermost; every phase lies inside a "step"
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0:
                name, _, p1 = phases[i]
                if p1 >= mid:
                    where = name
                    break
                if name == "step":
                    break
                i -= 1
            by[where] += b - a
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
