"""The traced run: spans around the calls into each layer, and the
profiler's device timeline reduced to intervals.

``Spans`` records host spans (name, start, end in ns) from the benchmark's
own code; in a traced run each span is also a ``record_function`` range,
so the profiler's timeline carries it.  ``Profile`` runs
``torch.profiler`` (CPU and CUDA activities) over a part of the window
and reduces its raw events to:

* ``kernels``: device intervals (kernels, copies, sets) with name and the
  host time of their launch, linked by correlation id, and beside them
  ``card``, the card each ran on;
* ``cpu``: host events (ops, runtime calls, the spans) per thread;
* ``window``: the traced window, the span named ``window``.

``wrap`` puts a span around a function of the program (by module and
attribute) for the traced part only, so a metric can name the calls it
reads without the program being changed; ``unwrap`` restores it.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field

import torch


def synchronize(devices) -> None:
    """Wait until every CUDA card among ``devices`` has finished its work."""
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Spans:
    """Host spans of the benchmark: ``spans[name]`` is a list of
    ``(start_ns, end_ns)``; ``annotate`` also marks them for the profiler.
    A span taken with ``sync`` ends when every card of ``devices`` (the
    cell's) has finished."""

    def __init__(self, devices=()):
        self.spans: dict[str, list[tuple[int, int]]] = {}
        self.annotate = False
        self.devices = list(devices)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        rf = (torch.profiler.record_function(f"portbench.{name}")
              if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter_ns()
        with rf:
            yield
            if sync:
                synchronize(self.devices)
        self.spans.setdefault(name, []).append((t0, time.perf_counter_ns()))

    def seconds(self, name: str) -> list[float]:
        return [(b - a) / 1e9 for a, b in self.spans.get(name, [])]


@dataclass
class Trace:
    kernels: list = field(default_factory=list)  # (start, end, name, launch_ns)
    card: list = field(default_factory=list)  # the card of each entry of kernels
    cpu: list = field(default_factory=list)  # (start, end, name, thread)
    window: tuple[int, int] | None = None
    exit_s: float = 0.0  # time the profiler took to stop and hand over
    cards: tuple[int, ...] = ()  # the cell's cards (CUDA device indices)

    def spans(self, name: str) -> list[tuple[int, int]]:
        """The profiler's intervals of benchmark span ``name``."""
        full = f"portbench.{name}"
        return [(a, b) for a, b, nm, _ in self.cpu if nm == full]

    def busy(self, lo: int, hi: int) -> float:
        """Seconds of [lo, hi) in which the device ran something: on a cell
        of several cards the mean over them of each card's own, so a card
        that waits for the others shows idle; else the union of every
        device interval."""
        if len(self.cards) < 2:
            return self._busy(lo, hi, self.kernels)
        by_card = self.busy_by_card(lo, hi)
        return sum(by_card.values()) / len(by_card)

    def busy_by_card(self, lo: int, hi: int) -> dict[int, float]:
        """Each of the cell's cards' busy seconds in [lo, hi)."""
        return {c: self._busy(lo, hi, [k for k, on in zip(self.kernels, self.card)
                                       if on == c])
                for c in self.cards}

    @staticmethod
    def _busy(lo: int, hi: int, kernels) -> float:
        return union_seconds([(max(a, lo), min(b, hi)) for a, b, *_ in kernels
                              if b > lo and a < hi])


def union_seconds(intervals) -> float:
    """Length in seconds of the union of ns intervals."""
    total, end = 0, None
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def busy_intervals(kernels) -> list[tuple[int, int]]:
    """The union of device intervals as a sorted list of disjoint ones."""
    out: list[list[int]] = []
    for a, b, *_ in sorted(kernels):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce_events(events, cards=()) -> Trace:
    """Raw kineto events -> ``Trace`` (see the module doc) of a cell on
    ``cards``.  Device events are those on a CUDA device; a host event
    named ``cuda*`` / ``cu*`` (a runtime or driver call) gives the launch
    time of the device event that shares its correlation id."""
    tr = Trace(cards=tuple(cards))
    launch: dict[int, int] = {}
    device = []
    ranges = set()  # host ranges, which the profiler also draws on the device
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        start, dur, name = ev.start_ns(), ev.duration_ns(), ev.name()
        if ev.device_type() == cuda:
            device.append((start, start + dur, name, ev.correlation_id(),
                           ev.device_index()))
            continue
        if name.startswith("cu"):
            launch[ev.correlation_id()] = start
        if name.startswith("portbench.") or getattr(ev, "is_user_annotation", bool)():
            ranges.add(name)
        tr.cpu.append((start, start + dur, name, ev.start_thread_id()))
    kept = [d for d in device if d[2] not in ranges]
    tr.kernels = [(a, b, nm, launch.get(cid, a)) for a, b, nm, cid, _ in kept]
    tr.card = [card for *_, card in kept]
    w = tr.spans("window")
    if w:
        tr.window = (min(a for a, _ in w), max(b for _, b in w))
    return tr


class Profile:
    """``torch.profiler`` over part of a run of a cell on ``devices``;
    ``stop`` returns the ``Trace``."""

    def __init__(self, devices):
        self.cards = [d.index for d in devices if d.type == "cuda"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cards:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # one cycle, read once from the raw events: nothing for
        # ``acc_events`` to keep, and it would parse every event in Python
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.__enter__()

    def stop(self) -> Trace:
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        tr = reduce_events(self.prof.profiler.kineto_results.events(), self.cards)
        tr.exit_s = time.perf_counter() - t0
        return tr


def resolve(target: str):
    """``"pkg.mod:attr"`` -> (module, attr)."""
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


def wrap(spans: Spans, name: str, target: str):
    """Put span ``name`` around the program's function ``target`` (while
    spans are annotated); returns an undo callable, or None if the
    program has no such function."""
    try:
        mod, attr = resolve(target)
    except (ImportError, ValueError):
        return None
    fn = getattr(mod, attr, None)
    if fn is None:
        return None

    def wrapped(*args, **kwargs):
        with spans.span(name):
            return fn(*args, **kwargs)

    setattr(mod, attr, wrapped)
    return lambda: setattr(mod, attr, fn)


def labelled_gaps(tr: Trace, lo: int, hi: int) -> list[tuple[str, int]]:
    """Idle gaps of the device inside [lo, hi), each labelled by what the
    host was doing at its middle: the innermost benchmark span and the
    outermost and innermost host op there.  Returns (label, ns) pairs."""
    busy = [(max(a, lo), min(b, hi)) for a, b in busy_intervals(tr.kernels)
            if b > lo and a < hi]
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    cpu = sorted(tr.cpu)
    out, nxt, active = [], 0, []
    for a, b in gaps:  # in time order: one sweep over the host events
        mid = (a + b) // 2
        while nxt < len(cpu) and cpu[nxt][0] <= mid:
            active.append(cpu[nxt][:3])
            nxt += 1
        active = [c for c in active if c[1] > mid]
        cover = active
        spans = [c for c in cover if c[2].startswith("portbench.")]
        ops = [c for c in cover if not c[2].startswith("portbench.")]
        parts = []
        if spans:
            parts.append(max(spans, key=lambda c: c[0])[2][len("portbench."):])
        if ops:
            outer = min(ops, key=lambda c: c[0])[2]
            inner = max(ops, key=lambda c: c[0])[2]
            parts.append(outer if outer == inner else f"{outer} > {inner}")
        out.append((" / ".join(parts) or "no host op", b - a))
    return out


def breakdown(tr: Trace, lo: int, hi: int, top: int = 10) -> dict:
    """The ``breakdown`` of a traced run: device seconds by op name and
    idle seconds by what the host was doing, the ``top`` largest each."""
    ops: dict[str, float] = {}
    for a, b, nm, _ in tr.kernels:
        if b > lo and a < hi:
            ops[nm] = ops.get(nm, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
    idle: dict[str, list] = {}
    for label, ns in labelled_gaps(tr, lo, hi):
        e = idle.setdefault(label, [0.0, 0])
        e[0] += ns / 1e9
        e[1] += 1
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(device_ops=[[k, v] for k, v in top_ops],
                idle_gaps=[[f"{k} ({n} gaps)", s] for k, (s, n) in top_idle])
