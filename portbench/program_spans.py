"""The program's own spans in a ``tracing.Trace``: ``record_function``
ranges that ``repro_torch`` opens while the profiler records
(``repro_torch/spans.py`` lists them), taken from the trace's host events
by exact name.  A program that opens none gives empty lists, and the
readers built on them give ``None``.

The profiler draws device intervals on a clock that is offset from its
host clock, by an amount that changes over a run (H100 hosts: from -8.4
to +0.04 ms, drifting by up to 2.4 ms a second).  A span's phase split
needs the two within microseconds, so each span is moved onto the
device's clock by the offset there: the least (start - launch) of the
device intervals launched in the ``ALIGN_NS`` up to the span's end.  A
device interval cannot start before its launch, so that is the offset
plus the least launch latency (microseconds: the serve loop launches onto
an idle device at each level's start, after the continue read), within
the drift over the window (about 24 us).
"""
from __future__ import annotations

import bisect
import itertools

from portbench.tracing import Trace

ALIGN_NS = 10_000_000


def ranges(tr: Trace, name: str) -> list[tuple[int, int]]:
    """The profiler's intervals (ns) of the program's span ``name``."""
    return sorted((a, b) for a, b, nm, _ in tr.cpu if nm == name)


class Timeline:
    """``tr``'s device intervals, looked up by launch and by start."""

    def __init__(self, tr: Trace):
        self.by_launch = sorted((at, a, b) for a, b, _, at in tr.kernels)
        self.launches = [k[0] for k in self.by_launch]
        self.by_start = sorted(tr.kernels)
        self.starts = [k[0] for k in self.by_start]
        self.reach = list(itertools.accumulate((k[1] for k in self.by_start), max))

    def launched(self, lo: int, hi: int) -> list[tuple[int, int, int]]:
        """(launch, start, end) of the intervals launched in [lo, hi)."""
        return self.by_launch[bisect.bisect_left(self.launches, lo):
                              bisect.bisect_left(self.launches, hi)]

    def offset(self, end: int) -> int:
        """The device clock's offset (ns) at a span ending at ``end``; 0
        where nothing was launched in the ``ALIGN_NS`` before it."""
        return min((s - at for at, s, _ in self.launched(end - ALIGN_NS, end)), default=0)

    def busy(self, a: int, b: int) -> float:
        """``Trace.busy`` over [a, b), reading only the intervals that can
        overlap it: past the last one whose run (and every earlier one's)
        ended by a, and starting before b."""
        lo, hi = bisect.bisect_right(self.reach, a), bisect.bisect_left(self.starts, b)
        return Trace(kernels=self.by_start[lo:hi]).busy(a, b)


def idle_ms(tr: Trace, name: str) -> float | None:
    """Mean over the spans ``name`` of the span's wall time less the time
    some device interval ran inside it, the span moved onto the device's
    clock, in ms."""
    spans = ranges(tr, name)
    if not spans:
        return None
    tl = Timeline(tr)
    idle = 0.0
    for a, b in spans:
        d = tl.offset(b)
        idle += (b - a) / 1e9 - tl.busy(a + d, b + d)
    return idle / len(spans) * 1e3
