"""The benchmark's parts on the CPU at toy sizes: the device generator, the
reference against the program's kernel-off path, the roofline formulas
and the metric readers."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import portbench.tests.toy  # noqa: F401  (puts src/ on the path)
from portbench import check, roofline
from portbench.graphgen import zipf_graph
from portbench.deploy import budget, make_graph
from portbench.reference import simrank as ref
from portbench.tracing import (Spans, Trace, breakdown, labelled_gaps, reduce_events,
                                union_seconds)


def graph(seed=7, n=400, m=3000, cap=25):
    gen = torch.Generator().manual_seed(seed)
    return zipf_graph(n, m, alpha=1.1, max_deg=cap, gen=gen)


@pytest.mark.parametrize("seed", [1, 2, 3_000_000_019])
def test_generator_keeps_the_cap_and_no_loops_or_duplicates(seed):
    g = graph(seed)
    src, dst, n = g["src"], g["dst"], g["n"]
    assert g["m"] == src.numel() == 3000
    assert not bool((src == dst).any())
    assert torch.unique(src * n + dst).numel() == g["m"]
    assert int(torch.bincount(dst, minlength=n).max()) <= 25
    again = graph(seed)
    assert torch.equal(again["src"], src) and torch.equal(again["dst"], dst)


def test_generator_follows_popularity():
    g = graph(5, n=400, m=3000, cap=1000)
    deg = torch.bincount(g["dst"], minlength=400)
    top = g["perm"][:5]  # the five most popular ranks
    assert float(deg[top].float().mean()) > 5 * float(deg.float().mean())
    assert not torch.equal(graph(6)["src"], graph(5)["src"])


@pytest.mark.parametrize("m", [1, 2999, 7000])
def test_generator_keeps_exactly_m_over_rounds(m):
    """Draws go on in rounds until m edges are kept (7,000 needs several
    rounds under the cap of 25), and the result is cut to exactly m."""
    g = graph(3, m=m)
    assert g["m"] == g["src"].numel() == m
    assert int(torch.bincount(g["dst"], minlength=400).max()) <= 25
    assert torch.unique(g["src"] * 400 + g["dst"]).numel() == m


def test_a_graph_short_of_its_m_stops_the_run():
    cfg = dict(name="tiny", n=10, m=95, graph=dict(model="zipf", alpha=1.1, max_deg=9))
    with pytest.raises(RuntimeError, match="kept"):
        make_graph(cfg, 1, "cpu")  # 10 nodes, 9 in-edges each: 90 at most
    ok = make_graph({**cfg, "m": 60}, 1, "cpu")
    assert ok["m"] == len(ok["src_h"]) == 60


def program_graph(g):
    from repro_torch.graph.structs import ell_from_edges, graph_from_edges

    s, d = g["src"].numpy().astype(np.int32), g["dst"].numpy().astype(np.int32)
    return (graph_from_edges(s, d, g["n"], device="cpu"),
            ell_from_edges(s, d, g["n"], device="cpu"), s, d)


def test_reference_walks_equal_the_programs():
    from repro_torch.core.walks import walks_from_uniforms

    g = graph(11)
    coo, eg, _, _ = program_graph(g)
    csr = ref.in_csr(g["src"], g["dst"], g["n"])
    cont, pick = ref.draw(99, 500, 7, math.sqrt(0.6), "cpu", steps_first=False)
    starts = torch.full((500,), 17, dtype=torch.int64)
    mine = ref.walks_from(csr, starts, cont, pick, g["n"])
    theirs = walks_from_uniforms(eg, 17, cont, pick)
    assert torch.equal(mine, theirs.long())


@pytest.mark.parametrize("lanes", [64, 256])
def test_reference_equals_kernel_off_drain(lanes):
    """A drained batch through the program's kernel-off path against the
    reference, estimate by estimate (fp32 against float64)."""
    from repro_torch.core.multisource import multi_source
    from repro_torch.core.params import make_params

    g = graph(12)
    coo, eg, _, _ = program_graph(g)
    n = g["n"]
    params = make_params(n, c=0.6, eps_a=0.3, delta=0.01)
    b = budget(n, 0.6, 0.3, 0.01)
    assert (b["n_r"], b["max_len"]) == (params.n_r, params.max_len)
    assert b["eps_p"] == pytest.approx(params.eps_p, rel=1e-12)
    us, seeds = [3, 50, 77], [101, 202, 303]
    est = multi_source(None, coo, eg, us, params, lanes=lanes, use_kernel=False,
                       seeds=seeds)
    csr = ref.in_csr(g["src"], g["dst"], n)
    for q, (u, s) in enumerate(zip(us, seeds)):
        cont, pick = ref.draw(s, b["n_r"], b["max_len"] - 1, b["sqrt_c"], "cpu",
                              steps_first=False)
        walks = ref.walks_from(csr, torch.full((b["n_r"],), u), cont, pick, n)
        r = ref.probe_sum(csr, g["src"], g["dst"], walks, sqrt_c=b["sqrt_c"],
                          eps_p=b["eps_p"]) / b["n_r"]
        r[u] = 1.0
        assert float((est[q].double() - r).abs().max()) < 1e-6


def test_reference_equals_production_step():
    from repro_torch.configs.base import ProbeSimConfig
    from repro_torch.core.distributed import build_sharded_graph, make_serve_step
    from repro_torch.launch.mesh import ShardMesh

    g = graph(13, n=256, m=1800, cap=40)
    _, _, s, d = program_graph(g)
    n = g["n"]
    sg = build_sharded_graph(s, d, n, mesh=ShardMesh(["cpu"]), pad_nodes=128,
                             pad_edges=4096)
    b = budget(n, 0.6, 0.3, 0.01)
    step = make_serve_step(ProbeSimConfig(name="t", n=n, m=g["m"]), queries=2,
                           walk_chunk=32, max_len=b["max_len"], top_k=10)
    gen = torch.Generator().manual_seed(4242)
    idx, vals = step(sg, torch.tensor([5, 9], dtype=torch.int32), gen)
    csr = ref.in_csr(g["src"], g["dst"], n)
    cont, pick = ref.draw(4242, 64, b["max_len"] - 1, b["sqrt_c"], "cpu",
                          steps_first=True)
    for j, u in enumerate([5, 9]):
        rows = slice(32 * j, 32 * (j + 1))
        walks = ref.walks_from(csr, torch.full((32,), u), cont[rows], pick[rows], n)
        est = ref.probe_sum(csr, g["src"], g["dst"], walks, sqrt_c=b["sqrt_c"],
                            eps_p=0.0) / 32
        assert check.topk_gap(idx[j].numpy(), vals[j].numpy(), est, u) < 1e-6


def test_topk_gap_catches_a_wrong_node_or_score():
    est = torch.tensor([0.0, 0.5, 0.4, 0.3, 0.0, 0.1], dtype=torch.float64)
    assert check.topk_gap([1, 2], [0.5, 0.4], est, 0) == 0.0
    # node 5 is not second: its score is right, its place is not
    assert check.topk_gap([1, 5], [0.5, 0.1], est, 0) == pytest.approx(0.3 / 0.5)
    # a score 0.01 off, relative to the top score 0.5
    assert check.topk_gap([1, 2], [0.5, 0.41], est, 0) == pytest.approx(0.02)


def test_roofline_formulas_by_hand():
    # 4 live slots over 3 rows, 2 distinct sources, 8 lanes of fp32:
    # 16 (slots) + 24 (row_len, weights) + 64 (source rows) + 96 (out)
    assert roofline.lane_probe_level_bytes(live_slots=4, n=3, sources=2, lanes=8,
                                           itemsize=4) == 200
    # 5 edges (40 B), a [4, 2] fp32 frontier in (32 B) and out (32 B)
    assert roofline.push_level_bytes(live_edges=5, n_pad=4, cols=2) == 104
    assert roofline.share_pct(3.35e9, 1e-3, 3.35e12) == pytest.approx(100.0)
    assert roofline.share_pct(1.0, 0.0, 3.35e12) is None
    assert roofline.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12


def toy_trace():
    ms = 1_000_000
    tr = Trace()
    # two drains of 10 ms; lane_probe kernels of 2 ms launched inside them
    tr.cpu = [(0, 10 * ms, "portbench.drain", 1), (12 * ms, 22 * ms, "portbench.drain", 1),
              (1 * ms, 2 * ms, "portbench.push", 1), (4 * ms, 5 * ms, "aten::item", 1)]
    tr.kernels = [(1 * ms, 3 * ms, "lane_probe_kernel", 1 * ms),
                  (5 * ms, 7 * ms, "lane_probe_kernel", 4 * ms),
                  (13 * ms, 15 * ms, "lane_probe_kernel", 12 * ms),
                  (16 * ms, 17 * ms, "indexFuncLargeIndex", 14 * ms)]
    tr.window = (0, 22 * ms)
    return tr


def ctx(**kw):
    base = dict(trace=toy_trace(), spans=Spans(), units=2, window=(0, 22_000_000),
                counters=dict(lane_probe_launches=600),
                peak_bw=3.35e12,
                facts=dict(live_slots=4, n=3, sources=2, lanes=8, itemsize=4,
                           live_edges=5, n_pad=4, cols=2))
    return {**base, **kw}


def read(name, c):
    from portbench.harness import reader

    return reader("metrics", name).read(c)


def test_readers_on_a_toy_trace():
    c = ctx()
    assert read("levels_per_batch", c) == 300
    # busy 7 ms of 22
    assert read("device_idle_pct", c) == pytest.approx(100 * (1 - 7 / 22))
    # drains: 20 ms wall, 7 ms busy inside, 3 lane_probe launches
    assert read("host_ms_per_level", c) == pytest.approx(13 / 3)
    assert read("lane_probe_roofline_pct", c) == pytest.approx(
        100 * 3 * 200 / 3.35e12 / 6e-3)
    # the push span holds the launch at 1 ms: one level, 2 ms
    assert read("push_roofline_pct", c) == pytest.approx(100 * 104 / 3.35e12 / 2e-3)
    # a split metric is read by its stem's reader
    assert read("device_idle_pct.step", c) == read("device_idle_pct", c)


@pytest.mark.parametrize("name", ["levels_per_batch", "host_ms_per_level",
                                  "lane_probe_roofline_pct", "push_roofline_pct",
                                  "device_idle_pct", "device_idle_pct.step"])
def test_readers_return_nothing_without_input(name):
    empty = Trace(window=(0, 1))
    assert read(name, ctx(trace=empty, counters={}, units=0)) is None


MS = 1_000_000
# card 0 busy 0-6 ms (6 ms), card 1 busy 1-3 ms (2 ms); the union is 0-6 ms
ON_TWO = [(0, 4 * MS, "k", 0), (2 * MS, 6 * MS, "k", 0), (1 * MS, 3 * MS, "k", 0)]


def test_busy_is_the_mean_over_the_cells_cards():
    two = Trace(kernels=ON_TWO, card=[0, 0, 1], cards=(0, 1))
    assert two.busy_by_card(0, 10 * MS) == {0: 6e-3, 1: 2e-3}
    assert two.busy(0, 10 * MS) == pytest.approx(4e-3)
    assert read("device_idle_pct", ctx(trace=two, window=(0, 10 * MS))) == pytest.approx(60)
    # a card of the cell that ran nothing is idle all through
    assert Trace(kernels=ON_TWO, card=[0, 0, 0], cards=(0, 1)).busy(0, 10 * MS) == 3e-3
    # one card that holds them all: the union, as with no cards named
    union = union_seconds([k[:2] for k in ON_TWO])
    assert union == 6e-3
    assert Trace(kernels=ON_TWO, card=[0, 0, 0], cards=(0,)).busy(0, 10 * MS) == union
    assert Trace(kernels=ON_TWO).busy(0, 10 * MS) == union


class Event:
    """A raw profiler event as ``reduce_events`` reads it."""

    def __init__(self, start, end, name, *, card=None, cid=0):
        self.args = (start, end, name, card, cid)

    def start_ns(self):
        return self.args[0]

    def duration_ns(self):
        return self.args[1] - self.args[0]

    def name(self):
        return self.args[2]

    def device_type(self):
        cuda = self.args[3] is not None
        return torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def device_index(self):
        return self.args[3]

    def correlation_id(self):
        return self.args[4]

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self.args[2].startswith("portbench.")


def test_reduce_events_keeps_each_intervals_card():
    events = [Event(0, 10 * MS, "portbench.window"),
              Event(0, 1, "cudaLaunchKernel", cid=7), Event(9, 10, "cudaLaunchKernel", cid=8)]
    events += [Event(a, b, f"k{i}", card=c, cid=7 + i)
               for i, ((a, b, *_), c) in enumerate(zip(ON_TWO, [0, 1, 1]))]
    # the profiler also draws the host range on the device: not a device interval
    events.append(Event(0, 10 * MS, "portbench.window", card=0))
    tr = reduce_events(events, cards=(0, 1))
    assert tr.window == (0, 10 * MS) and tr.cards == (0, 1)
    assert [k[2] for k in tr.kernels] == ["k0", "k1", "k2"] and tr.card == [0, 1, 1]
    assert [k[3] for k in tr.kernels] == [0, 9, 1 * MS]  # k2 has no launch: its start
    assert tr.busy_by_card(0, 10 * MS) == {0: 4e-3, 1: 5e-3}
    assert tr.busy(0, 10 * MS) == pytest.approx(4.5e-3)


def test_idle_gaps_are_labelled_by_the_host():
    tr = toy_trace()
    gaps = dict(labelled_gaps(tr, 0, 22_000_000))
    assert gaps["drain / aten::item"] == 2_000_000  # 3-5 ms: mid-gap in the item
    out = breakdown(tr, *tr.window)
    assert out["device_ops"][0] == ["lane_probe_kernel", pytest.approx(6e-3)]
    assert len(out["idle_gaps"]) <= 10


@pytest.mark.parametrize("count,want", [(1, 1), (7, 1), (7, 3), (2, 5), (0, 1)])
def test_check_picks_whole_units_from_the_seed(count, want):
    picked = check.pick_units(11, count, want)
    assert picked == check.pick_units(11, count, want)
    assert len(set(picked)) == len(picked) == min(count, want)
    assert all(0 <= i < count for i in picked) and picked == sorted(picked)


def test_worst_topk_gap_takes_the_worst_answer():
    est = torch.tensor([0.0, 0.5, 0.4, 0.3], dtype=torch.float64)
    answers = [dict(node=0, idx=[1, 2], vals=[0.5, 0.4]),
               dict(node=0, idx=[1, 2], vals=[0.5, 0.45]),
               dict(node=0, idx=[1, 2], vals=[0.5, 0.41])]
    assert check.worst_topk_gap(answers, lambda a: est) == pytest.approx(0.1)
    assert check.worst_topk_gap([], lambda a: est) == 0.0
