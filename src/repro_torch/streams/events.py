"""Temporal event model: timestamped edge arrivals + sliding-window expiry
(port of ``repro.streams.events``; the generators and the expirer are
copies, pinned bitwise equal by ``tests/test_torch_streams.py``).

ProbeSim is index-free, so a time-varying graph (the Dynamical SimRank
setting, arxiv 1711.00121) costs only the update batches themselves.  This
module supplies the workload half of that story:

* :class:`EventStream` — a time-ordered SoA of timestamped edge arrivals,
  produced by the arrival-process generators (:func:`poisson_edge_stream`,
  :func:`bursty_edge_stream`, :func:`preferential_attachment_stream`).

* :class:`SlidingWindowExpirer` — turns a TTL horizon into delete-heavy
  update batches: every edge older than ``ttl`` is expired FIFO (oldest
  first), so the deletes it derives hit the FIRST live copy of each pair
  in the edge buffer.  Because ``graph/dynamic.py``'s coordinated apply
  deletes by first match with stable compaction and appends inserts, the
  maintained COO+ELL mirrors stay **bit-identical** to rebuilding the live
  window from scratch in arrival order (the invariant
  ``tests/test_streams.py`` pins).

Everything here is host-side numpy — device work happens downstream in
whatever applies the derived batches (session, epoch step, or service);
``expire_batches`` places its batches on ``device`` (the card unless the
caller says otherwise).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.graph.dynamic import UpdateBatch, make_update_batch

__all__ = [
    "EdgeEvent",
    "EventStream",
    "SlidingWindowExpirer",
    "bursty_edge_stream",
    "poisson_edge_stream",
    "preferential_attachment_stream",
]


@dataclass(frozen=True)
class EdgeEvent:
    """One timestamped edge operation (``insert=False`` is a deletion)."""

    t: float
    src: int
    dst: int
    insert: bool = True


class EventStream:
    """Time-ordered edge arrivals in SoA form (``t`` float64, ids int32).

    Generators produce *arrival* streams (inserts only); deletions are
    derived downstream by a :class:`SlidingWindowExpirer` TTL horizon, so
    the stream itself stays a pure record of what arrived when.
    """

    __slots__ = ("t", "src", "dst", "n")

    def __init__(self, t, src, dst, n: int):
        self.t = np.asarray(t, np.float64).reshape(-1)
        self.src = np.asarray(src, np.int32).reshape(-1)
        self.dst = np.asarray(dst, np.int32).reshape(-1)
        self.n = int(n)
        if not (len(self.t) == len(self.src) == len(self.dst)):
            raise ValueError(
                f"ragged event stream: t={len(self.t)} src={len(self.src)} "
                f"dst={len(self.dst)}"
            )
        if len(self.t) and np.any(np.diff(self.t) < 0):
            raise ValueError("event times must be nondecreasing")
        if len(self.src):
            lo = min(int(self.src.min()), int(self.dst.min()))
            hi = max(int(self.src.max()), int(self.dst.max()))
            if lo < 0 or hi >= self.n:
                raise ValueError(
                    f"event endpoints out of range [0, {self.n}): "
                    f"saw [{lo}, {hi}]"
                )

    def __len__(self) -> int:
        return len(self.t)

    @property
    def horizon(self) -> float:
        """Timestamp of the last arrival (0.0 for an empty stream)."""
        return float(self.t[-1]) if len(self.t) else 0.0

    def events(self) -> Iterator[EdgeEvent]:
        for i in range(len(self.t)):
            yield EdgeEvent(
                float(self.t[i]), int(self.src[i]), int(self.dst[i])
            )

    def slice_time(self, lo: float, hi: float) -> "EventStream":
        """Arrivals with ``lo < t <= hi`` (half-open, replay-tick shaped)."""
        a = int(np.searchsorted(self.t, lo, side="right"))
        b = int(np.searchsorted(self.t, hi, side="right"))
        return EventStream(self.t[a:b], self.src[a:b], self.dst[a:b], self.n)


def _endpoints(rng: np.random.Generator, n: int, m: int):
    """m uniform self-loop-free (src, dst) pairs (dst resampled by offset)."""
    src = rng.integers(0, n, size=m, dtype=np.int64)
    # dst != src without rejection: a uniform nonzero offset mod n
    dst = (src + rng.integers(1, n, size=m, dtype=np.int64)) % n
    return src.astype(np.int32), dst.astype(np.int32)


def poisson_edge_stream(
    n: int, rate: float, horizon: float, *, seed: int = 0
) -> EventStream:
    """Steady-state arrivals: a Poisson process at ``rate`` edges per
    virtual second over ``[0, horizon]``, uniform self-loop-free endpoints.
    """
    if n < 2:
        raise ValueError(f"need n >= 2 nodes, got {n}")
    if rate <= 0 or horizon <= 0:
        raise ValueError("rate and horizon must be > 0")
    rng = np.random.default_rng(seed)
    # draw in chunks of the expected count until past the horizon
    t: list[np.ndarray] = []
    last = 0.0
    expect = max(16, int(rate * horizon * 1.1))
    while last <= horizon:
        gaps = rng.exponential(1.0 / rate, size=expect)
        chunk = last + np.cumsum(gaps)
        t.append(chunk)
        last = float(chunk[-1])
    ts = np.concatenate(t)
    ts = ts[ts <= horizon]
    src, dst = _endpoints(rng, n, len(ts))
    return EventStream(ts, src, dst, n)


def bursty_edge_stream(
    n: int,
    *,
    rate_on: float,
    rate_off: float = 0.0,
    mean_on: float,
    mean_off: float,
    horizon: float,
    seed: int = 0,
) -> EventStream:
    """On/off modulated Poisson arrivals: exponentially-distributed ON
    phases at ``rate_on`` alternate with OFF phases at ``rate_off``
    (default silent), starting ON at t=0.  Models burst ingest — the
    workload shape that stresses the admission/staleness path.
    """
    if n < 2:
        raise ValueError(f"need n >= 2 nodes, got {n}")
    if rate_on <= 0 or mean_on <= 0 or mean_off <= 0 or horizon <= 0:
        raise ValueError("rate_on, mean_on, mean_off, horizon must be > 0")
    rng = np.random.default_rng(seed)
    t: list[np.ndarray] = []
    now, on = 0.0, True
    while now < horizon:
        dur = float(rng.exponential(mean_on if on else mean_off))
        end = min(now + dur, horizon)
        rate = rate_on if on else rate_off
        if rate > 0:
            count = rng.poisson(rate * (end - now))
            if count:
                t.append(np.sort(rng.uniform(now, end, size=count)))
        now, on = end, not on
    ts = np.concatenate(t) if t else np.empty(0, np.float64)
    src, dst = _endpoints(rng, n, len(ts))
    return EventStream(ts, src, dst, n)


def preferential_attachment_stream(
    n: int,
    rate: float,
    horizon: float,
    *,
    seed: int = 0,
    p_uniform: float = 0.25,
) -> EventStream:
    """Growth arrivals with rich-get-richer destinations: each new edge
    copies the destination of a uniformly random earlier edge with
    probability ``1 - p_uniform`` (degree-proportional attachment without
    maintaining a degree table), else picks a uniform node — so the
    windowed in-degree distribution is heavy-tailed like real graphs.
    """
    if not 0.0 < p_uniform <= 1.0:
        raise ValueError(f"p_uniform must be in (0, 1], got {p_uniform}")
    base = poisson_edge_stream(n, rate, horizon, seed=seed)
    m = len(base)
    if m == 0:
        return base
    rng = np.random.default_rng(seed + 1)
    uniform = rng.random(m) < p_uniform
    ref = (rng.random(m) * np.arange(m)).astype(np.int64)  # ref[i] < i
    dst = base.dst.copy()
    for i in range(1, m):
        if not uniform[i]:
            dst[i] = dst[ref[i]]
    # keep self-loop-freedom after copying
    clash = dst == base.src
    if clash.any():
        dst[clash] = (base.src[clash] + 1) % n
    return EventStream(base.t, base.src, dst, n)


class SlidingWindowExpirer:
    """FIFO TTL window over an arrival stream, emitting delete batches.

    ``ingest`` records arrivals in stream order; ``expire_until(now)``
    pops every edge with ``t <= now - ttl`` **oldest first** and returns
    the (src, dst) delete ops.  Because deletion order matches buffer
    order, applying those ops through ``apply_update_batch`` (first-match
    delete, stable compaction) keeps the maintained mirrors bit-identical
    to a from-scratch rebuild of :meth:`live_edges` — the live window in
    arrival order.  ``expire_batches`` packages the same ops as
    sentinel-padded :class:`UpdateBatch` es directly.
    """

    def __init__(self, ttl: float):
        if not ttl > 0:
            raise ValueError(f"ttl must be > 0, got {ttl}")
        self.ttl = float(ttl)
        self._t: list[float] = []
        self._src: list[int] = []
        self._dst: list[int] = []
        self._head = 0  # first live index
        self._last_ingest = -np.inf
        self._last_now = -np.inf
        self.expired_total = 0

    # -- ingest --------------------------------------------------------------

    def ingest(self, t, src, dst) -> int:
        """Record arrivals (time-ordered within and across calls)."""
        t = np.asarray(t, np.float64).reshape(-1)
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        if not (len(t) == len(src) == len(dst)):
            raise ValueError("ragged ingest")
        if len(t) == 0:
            return 0
        if np.any(np.diff(t) < 0) or t[0] < self._last_ingest:
            raise ValueError("ingest times must be nondecreasing")
        self._last_ingest = float(t[-1])
        self._t.extend(t.tolist())
        self._src.extend(src.tolist())
        self._dst.extend(dst.tolist())
        return len(t)

    def ingest_stream(self, stream: EventStream) -> int:
        return self.ingest(stream.t, stream.src, stream.dst)

    # -- expiry --------------------------------------------------------------

    def expire_until(self, now: float) -> tuple[np.ndarray, np.ndarray]:
        """Delete ops (src, dst) for every edge with ``t <= now - ttl``,
        oldest first; advances the window."""
        if now < self._last_now:
            raise ValueError("expire_until times must be nondecreasing")
        self._last_now = float(now)
        cutoff = now - self.ttl
        h = self._head
        end = h
        total = len(self._t)
        while end < total and self._t[end] <= cutoff:
            end += 1
        src = np.asarray(self._src[h:end], np.int32)
        dst = np.asarray(self._dst[h:end], np.int32)
        self._head = end
        self.expired_total += end - h
        if self._head > 4096 and self._head * 2 > len(self._t):
            del self._t[: self._head]
            del self._src[: self._head]
            del self._dst[: self._head]
            self._head = 0
        return src, dst

    def expire_batches(
        self, now: float, *, batch_size: int, n: int, device="cuda"
    ) -> list[UpdateBatch]:
        """The same expiry as sentinel-padded delete ``UpdateBatch`` es on
        ``device``, ready for ``apply_update_batch`` /
        ``GraphHandle.apply_batch``."""
        src, dst = self.expire_until(now)
        return [
            make_update_batch(
                src[i: i + batch_size], dst[i: i + batch_size], False,
                batch_size=batch_size, n=n, device=device,
            )
            for i in range(0, len(src), batch_size)
        ]

    # -- the live window -----------------------------------------------------

    @property
    def live(self) -> int:
        return len(self._t) - self._head

    @property
    def oldest_t(self) -> float | None:
        return self._t[self._head] if self._head < len(self._t) else None

    def live_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) of the live window in arrival order — the rebuild
        reference for the bitwise-equality invariant, and the frozen
        snapshot effectiveness checkpoints evaluate against."""
        return (
            np.asarray(self._src[self._head:], np.int32),
            np.asarray(self._dst[self._head:], np.int32),
        )

    def live_times(self) -> np.ndarray:
        return np.asarray(self._t[self._head:], np.float64)
