"""The port's program spans (``repro_torch.spans``): an off span costs no
``record_function`` call; under the profiler ``fused_serve`` opens one
draw and one epilogue a batch and one level and one continue span a
level, the production probe one push span a push level, the train step
its forward and update spans; no program span lies inside another; and a
batch answers the same with the profiler on."""
import contextlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.distributed as TD
import repro_torch.core.multisource as ms
import repro_torch.kernels.lane_probe.ops as lane_ops
from repro_torch import spans
from repro_torch.api.handle import GraphHandle
from repro_torch.core.params import make_params
from repro_torch.graph.generators import powerlaw_graph
from repro_torch.launch.mesh import ShardMesh
from repro_torch.training.optimizer import AdamW, constant_schedule
from repro_torch.training.step import make_train_step
from torch_port_helpers import needs_cuda, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PROGRAM = ("fused_serve.draw", "fused_serve.level", "fused_serve.continue",
           "fused_serve.epilogue", "serve_step.push",
           "train_step.forward", "train_step.update")
US, SEEDS = [3, 11, 42], [5, 6, 3_000_000_019]


def edges():
    return powerlaw_graph(160, 1100, seed=2, alpha=1.6)


def handle(device="cpu"):
    src, dst, n = edges()
    return GraphHandle.from_edges(src, dst, n, device=device)


def serve(h, **kw):
    p = make_params(h.n, c=0.6, eps_a=0.3, n_r_override=96)
    return ms.fused_serve(h.g, h.eg, US, seeds=SEEDS, n_r=p.n_r, lanes_q=32,
                          max_len=p.max_len, sqrt_c=p.sqrt_c, eps_p=p.eps_p,
                          eps_t=p.eps_t, truncation_shift=p.truncation_shift,
                          top_k=8, **kw)


def traced(fn, cuda=False):
    """``fn()`` under the profiler; returns its result and the program's
    spans as sorted (start, end, name) in us."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
    got = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.name in PROGRAM and e.device_type != torch.autograd.DeviceType.CUDA)
    return out, got


def counts(got):
    out = {}
    for _, _, name in got:
        out[name] = out.get(name, 0) + 1
    return out


def assert_flat(got):
    for (_, end, a), (start, _, b) in zip(got, got[1:]):
        assert start >= end, f"{b} opens inside {a}"


def counted(monkeypatch, mod, attr):
    """Count the calls of ``mod.attr`` (the CPU runs the kernels' plain
    versions, which the launch counters do not count)."""
    fn, calls = getattr(mod, attr), [0]

    def wrapped(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(mod, attr, wrapped)
    return calls


def test_off_span_is_the_shared_null_context(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    off = spans.span("fused_serve.level")
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("serve_step.push") is off
    made = counted(monkeypatch, torch.profiler, "record_function")
    serve(handle())
    assert made[0] == 0


def test_span_is_a_range_under_the_profiler():
    def one():
        with spans.span("train_step.update") as s:
            return s

    rf, got = traced(one)
    assert isinstance(rf, torch.profiler.record_function)
    assert [name for *_, name in got] == ["train_step.update"]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_fused_serve_spans_per_level(monkeypatch, use_kernel):
    launches = counted(monkeypatch, lane_ops, "lane_probe_level")
    reads = counted(monkeypatch, ms, "lane_continue")
    _, got = traced(lambda: serve(handle(), use_kernel=use_kernel))
    c = counts(got)
    assert reads[0] > 1
    assert launches[0] == (reads[0] if use_kernel else 0)
    assert c == {"fused_serve.draw": 1, "fused_serve.epilogue": 1,
                 "fused_serve.level": reads[0], "fused_serve.continue": reads[0]}
    assert_flat(got)
    assert got[0][2] == "fused_serve.draw" and got[-1][2] == "fused_serve.epilogue"


@pytest.mark.parametrize("shards", [1, 2])
def test_production_probe_one_push_span_a_level(monkeypatch, shards):
    src, dst, n = edges()
    sg = TD.build_sharded_graph(src, dst, n, mesh=ShardMesh(["cpu"] * shards),
                                pad_nodes=32, pad_edges=64)
    step = TD.make_serve_step(types.SimpleNamespace(c=0.6), queries=2,
                              walk_chunk=16, max_len=6, top_k=5)
    pushes = counted(monkeypatch, TD, "coo_push")
    gen = torch.Generator().manual_seed(7)
    _, got = traced(lambda: step(sg, torch.tensor([3, 11], dtype=torch.int32), gen))
    assert pushes[0] == 5  # max_len - 1 push levels
    assert counts(got) == {"serve_step.push": 5}
    assert_flat(got)


def test_answers_equal_with_and_without_the_profiler():
    h = handle()
    plain = serve(h)
    on, got = traced(lambda: serve(h))
    assert got
    for a, b in zip(plain, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_spans(microbatches):
    w = torch.ones(4, 3, requires_grad=True)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3) / 24

    def loss_fn(p, batch):
        return (p["w"] * batch).square().mean(), {}

    opt = AdamW(constant_schedule(1e-2))
    params = {"w": w}
    step = make_train_step(loss_fn, opt, microbatches=microbatches)
    state = opt.init(params)
    batch = x if microbatches > 1 else x[0]
    _, got = traced(lambda: step(params, state, batch))
    assert counts(got) == {"train_step.forward": microbatches, "train_step.update": 1}
    assert_flat(got)


@pytest.mark.cuda
def test_level_spans_match_the_kernel_launches_on_card():
    needs_cuda()
    h = handle("cuda")
    serve(h)  # build and load the kernel outside the profile
    before = lane_ops.lane_probe_level.launches
    plain = serve(h)
    levels = lane_ops.lane_probe_level.launches - before
    on, got = traced(lambda: serve(h), cuda=True)
    c = counts(got)
    assert levels > 1
    assert c["fused_serve.level"] == c["fused_serve.continue"] == levels
    assert lane_ops.lane_probe_level.launches - before == 2 * levels
    assert c["fused_serve.draw"] == c["fused_serve.epilogue"] == 1
    assert_flat(got)
    for a, b in zip(plain, on):
        assert torch.equal(a, b)
