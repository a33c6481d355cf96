"""The readers of the program's own spans (``level_issue_ms``,
``level_sync_ms``, ``walk_draw_ms``): by hand on a built trace, the same
under an offset and a drift of the device clock, nothing without the
spans, the windowed busy time against ``Trace.busy`` over every kernel,
and a traced toy run that reports them and labels its idle time by a
program span."""
from __future__ import annotations

import random

import pytest

from portbench.program_spans import idle_ms
from portbench.tests.toy import run
from portbench.tracing import Spans, Trace, labelled_gaps

MS = 1_000_000
NEW = ["level_issue_ms", "level_sync_ms", "walk_draw_ms"]


def span_trace():
    tr = Trace()
    tr.cpu = [(0, 22 * MS, "portbench.drain", 1),
              (0, 2 * MS, "fused_serve.draw", 1),
              (4 * MS, 6 * MS, "fused_serve.level", 1),
              (6 * MS, 8 * MS, "fused_serve.continue", 1),
              (6 * MS + MS // 10, 8 * MS - MS // 10, "aten::item", 1),
              (8 * MS, 10 * MS, "fused_serve.level", 1),
              (10 * MS, 11 * MS, "fused_serve.continue", 1),
              (20 * MS, 21 * MS, "fused_serve.draw", 1)]
    # (start, end, name, launch): the draw launches a kernel that runs on
    # past its span; the first level a lane_probe and an op queued behind
    # it; an op after the loop, shortly before the second draw, which
    # launches nothing
    tr.kernels = [(MS, 4 * MS, "gather", MS),
                  (5 * MS, 7 * MS, "lane_probe_kernel", 5 * MS),
                  (7 * MS + MS // 2, 8 * MS + MS // 2, "where", 5 * MS + MS // 2),
                  (11 * MS + MS // 2, 12 * MS, "sum", 11 * MS + MS // 2)]
    tr.window = (0, 22 * MS)
    return tr


def read(name, tr):
    from portbench.harness import reader

    ctx = dict(trace=tr, spans=Spans(), units=1, window=tr.window or (0, 1),
               counters={}, peak_bw=3.35e12, facts={})
    return reader("metrics", name).read(ctx)


def test_program_span_readers_by_hand():
    tr = span_trace()
    # levels: 4-6 ms with 5-6 busy (1 ms idle); 8-10 ms with 8-8.5 busy (1.5)
    assert read("level_issue_ms", tr) == pytest.approx(1.25)
    # continues: 6-8 ms with 6-7 and 7.5-8 busy (0.5 idle); 10-11 ms idle (1)
    assert read("level_sync_ms", tr) == pytest.approx(0.75)
    # draws: 0 ms to the end of the gather it launched (4 ms); 20-21 ms (1)
    assert read("walk_draw_ms", tr) == pytest.approx(2.5)
    # the breakdown names the phase the host was in
    gaps = dict(labelled_gaps(tr, *tr.window))
    assert gaps["drain / fused_serve.draw"] == MS
    assert gaps["drain / fused_serve.level"] == MS
    assert gaps["drain / fused_serve.continue > aten::item"] == MS // 2


def skewed(tr, offset, drift):
    """``tr`` with its device clock ``offset`` ns ahead of the host's at 0,
    running ``drift`` faster (as the profiler draws it on some hosts)."""
    def at(t):
        return t + offset + int(drift * t)

    return Trace(kernels=[(at(a), at(b), nm, launch) for a, b, nm, launch in tr.kernels],
                 cpu=tr.cpu, window=tr.window)


@pytest.mark.parametrize("offset,drift", [(9 * MS // 10, 0.0), (-37 * MS // 10, 0.0),
                                          (-MS, -1.1e-3), (MS // 5, 3e-4)])
def test_program_span_readers_take_out_the_clock_offset(offset, drift):
    """An offset of the device clock moves a level's kernel into the
    continue span on the raw clocks; the readers read as without it, to
    within the drift over a span."""
    tr, moved = span_trace(), skewed(span_trace(), offset, drift)
    for name in NEW:
        assert read(name, moved) == pytest.approx(read(name, tr), abs=0.01), name
    if drift == 0:
        assert moved.busy(6 * MS, 8 * MS) != tr.busy(6 * MS, 8 * MS)


@pytest.mark.parametrize("name", NEW)
def test_program_span_readers_need_their_spans(name):
    tr = span_trace()
    tr.cpu = [c for c in tr.cpu if not c[2].startswith("fused_serve.")]
    assert read(name, tr) is None
    assert read(name, Trace(window=(0, 1))) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_ms_equals_busy_over_every_kernel(seed):
    """The reader looks only at the kernels near each span; that equals
    ``Trace.busy`` over all of them, also with overlapping and long ones
    (each starts at its launch: no clock offset)."""
    rng = random.Random(seed)
    tr = Trace()
    for _ in range(300):
        a = rng.randrange(0, 1000 * MS)
        tr.kernels.append((a, a + rng.choice([MS // 10, MS, 50 * MS]), "k", a))
    at = 0
    for _ in range(200):
        at += rng.randrange(0, 3 * MS)
        b = at + rng.randrange(1, 4 * MS)
        tr.cpu.append((at, b, "fused_serve.level", 1))
        at = b
    full = sum((b - a) / 1e9 - tr.busy(a, b) for a, b, *_ in tr.cpu) / 200 * 1e3
    assert idle_ms(tr, "fused_serve.level") == pytest.approx(full, rel=1e-12)


def test_traced_run_reports_the_program_spans():
    out = run("hepph.topk_bulk", trace=True)
    assert out["correct"], out["checks"]
    for name in NEW:
        assert out["metrics"][name]["value"] > 0, name
    assert any("fused_serve." in label for label, _ in out["breakdown"]["idle_gaps"])
