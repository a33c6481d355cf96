"""repro_torch's roofline (``roofline/analysis.py``, ``roofline/report.py``)
and the H100 constants and production mesh (``launch/mesh.py``), held
against repro's where repro has a counterpart.

``RooflineReport.finalize`` and the report's tables go through both
packages on the same inputs.  The op counter is checked on small CPU
tensors against counts written out by hand (a matmul is 2mnk; an
elementwise op reads each input and writes its output once; an index op
moves the rows it touches), the four kernel ops against their least-work
formulas (counted once, nothing inside them again; the plain CPU route
and the meta route alike), the formulas' live slots and distinct rows
against numpy, and the mesh's exchanges against their wire bytes.
"""
import json

import numpy as np
import pytest
import torch

import repro.roofline.analysis as JRA
import repro.roofline.report as JRR
from repro.launch.mesh import HW as J_HW

import repro_torch.roofline.analysis as RA
import repro_torch.roofline.report as RR
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.lane_probe.ops import lane_probe_level
from repro_torch.kernels.probe_push.ops import probe_push
from repro_torch.kernels.spmm_ell.ops import spmm_ell, spmm_ell_padded
from repro_torch.launch.mesh import HW, PEAK_EXP_PER_S, ShardMesh, make_production_mesh

RNG = np.random.default_rng(0)


def counted(fn):
    c = RA.OpCounter()
    with torch.inference_mode(), c:
        out = fn()
    return c, out


# ---------------------------------------------------------------------------
# Constants, mesh and report
# ---------------------------------------------------------------------------


def test_h100_peaks_and_production_mesh():
    assert HW == dict(peak_flops_bf16=989e12, peak_flops_fp32=67e12,
                      hbm_bw=3.35e12, hbm_bytes=80e9, ici_bw=450e9)
    assert set(J_HW) <= set(HW)  # the reference's keys, and the fp32 peak
    assert PEAK_EXP_PER_S == 132 * 16 * 1.83e9
    for multi, s in ((False, 256), (True, 512)):
        m = make_production_mesh(multi_pod=multi)
        assert m.shards == m.chips == s
        assert all(d.type == "meta" for d in m.devices)
        assert not m.single_device  # meta blocks stand for distinct cards
    cpu = make_production_mesh(devices=["cpu"] * 256)
    assert cpu.single_device and cpu.chips == 1
    with pytest.raises(ValueError, match="shards=256"):
        make_production_mesh(devices=["cpu"] * 4)


REPORT_INPUTS = [
    dict(chips=256, hlo_flops=3.8e15, hlo_bytes=1.5e12, collective_bytes=0.0,
         model_flops=8.5e17),
    dict(chips=512, hlo_flops=1.7e10, hlo_bytes=3.3e11, collective_bytes=4.7e11,
         model_flops=4.4e12),
    dict(chips=1, hlo_flops=0.0, hlo_bytes=2.0e9, collective_bytes=1e6,
         model_flops=0.0),
]


@pytest.mark.parametrize("inputs", REPORT_INPUTS)
@pytest.mark.parametrize("hw", ["reference", "port"])
def test_finalize_equals_repro(inputs, hw):
    """Equal terms, bottleneck and useful-FLOPs ratio on the same inputs.
    With the reference's table every FLOP is divided by its one peak, so
    the tensor-core share does not matter; with the port's, the reference
    sees all of them as tensor-core FLOPs."""
    table = J_HW if hw == "reference" else HW
    ref = JRA.RooflineReport(arch="a", shape="s", mesh="single", **inputs).finalize(table)
    splits = (0.0, 0.3, 1.0) if hw == "reference" else (1.0,)
    for share in splits:
        mine = RA.RooflineReport(arch="a", shape="s", mesh="single", **inputs,
                                 tensor_core_flops=share * inputs["hlo_flops"])
        mine.finalize(table)
        for k in ("compute_s", "memory_s", "collective_s", "useful_flops_ratio"):
            assert getattr(mine, k) == pytest.approx(getattr(ref, k), rel=1e-12, abs=0)
        assert mine.bottleneck == ref.bottleneck
        assert mine.roofline_s == max(ref.compute_s, ref.memory_s, ref.collective_s)


def test_finalize_splits_the_compute_term():
    """fp32 FLOPs are divided by the CUDA cores' peak, the tensor-core ones
    by the bf16 peak (an fp32 push is not credited with 989 TFLOP/s)."""
    rep = RA.RooflineReport(arch="a", shape="s", mesh="single", chips=1,
                            hlo_flops=1e12, hlo_bytes=0.0, collective_bytes=0.0,
                            model_flops=1e12, tensor_core_flops=4e11).finalize(HW)
    assert rep.compute_s == pytest.approx(4e11 / 989e12 + 6e11 / 67e12, rel=1e-12)
    assert rep.bottleneck == "compute" and rep.useful_flops_ratio == 1.0


RECORDS = [
    dict(arch="probesim", shape="serve_batch", mesh="single", applicable=True,
         compute_s=0.0114, memory_s=2.5, collective_s=1.03, bottleneck="memory",
         model_flops=4.4e12, useful_flops_ratio=0.0004),
    dict(arch="llama3-405b", shape="prefill_32k", mesh="single", applicable=True,
         compute_s=3.9, memory_s=0.46, collective_s=0.0, bottleneck="compute",
         model_flops=8.5e17, useful_flops_ratio=0.86),
    dict(arch="gcn-cora", shape="full_graph_sm", mesh="single", applicable=True,
         compute_s=2e-7, memory_s=3e-5, collective_s=0.0, bottleneck="memory",
         model_flops=1e6, useful_flops_ratio=0.5),
    dict(arch="yi-34b", shape="decode_32k", mesh="multi", applicable=True,
         compute_s=0.0, memory_s=0.0015, collective_s=0.7, bottleneck="collective",
         model_flops=1e9, useful_flops_ratio=1.2),
    dict(arch="llama3.2-1b", shape="long_500k", mesh="single", applicable=False,
         skip_reason="x"),
]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_table_equals_repro(mesh):
    """Every column but the hint (rewritten for the H100)."""
    ours = RR.roofline_table(RECORDS, mesh).splitlines()
    theirs = JRR.roofline_table(RECORDS, mesh).splitlines()
    assert len(ours) == len(theirs) > 2
    for a, b in zip(ours, theirs):
        assert a.split("|")[1:-2] == b.split("|")[1:-2]
    for x in (0, 3e-7, 2.5e-3, 0.7, 12.0):
        assert RR.fmt_s(x) == JRR.fmt_s(x)
    assert [RR.family_of(r["arch"]) for r in RECORDS] == \
        [JRR.family_of(r["arch"]) for r in RECORDS]
    assert set(RR.MOVE_HINTS) == set(JRR.MOVE_HINTS)
    assert not any("MXU" in h or "ICI" in h for h in RR.MOVE_HINTS.values())


def test_records_and_skip_table_equal_repro(tmp_path):
    for r in RECORDS:
        name = (f"{r['arch']}__{r['shape']}__skip.json" if not r["applicable"]
                else f"{r['arch']}__{r['shape']}__{r['mesh']}.json")
        (tmp_path / name).write_text(json.dumps(r))
    (tmp_path / "x__y__single.FAILED.json").write_text("{}")
    assert RR.load_records(str(tmp_path)) == JRR.load_records(str(tmp_path))
    assert RR.skip_table(str(tmp_path)) == JRR.skip_table(str(tmp_path))


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_matmul_is_2mnk(dtype):
    m, k, n = 7, 5, 3
    a = torch.randn(m, k).to(dtype)
    b = torch.randn(k, n).to(dtype)
    c, _ = counted(lambda: a @ b)
    item = a.element_size()
    assert c.flops == 2 * m * n * k
    assert c.tc_flops == (2 * m * n * k if dtype == torch.bfloat16 else 0)
    assert c.bytes == item * (m * k + k * n + m * n)
    # a batched matmul through einsum: the same rule, per batch
    x, y = torch.randn(4, m, k), torch.randn(4, k, n)
    c, _ = counted(lambda: torch.einsum("bmk,bkn->bmn", x, y))
    assert c.flops == 4 * 2 * m * n * k


def test_counter_elementwise_and_reduction():
    x, y = torch.randn(100), torch.randn(100)
    c, _ = counted(lambda: x + y)
    assert (c.flops, c.bytes) == (100, 3 * 400)
    c, _ = counted(lambda: x * 2.0)
    assert (c.flops, c.bytes) == (100, 2 * 400)
    # a broadcast input counts its distinct elements
    row = torch.randn(1, 8)
    grid = torch.randn(16, 8)
    c, _ = counted(lambda: grid + row.expand(16, 8))
    assert (c.flops, c.bytes) == (128, 4 * (128 + 8 + 128))
    c, _ = counted(lambda: grid.sum(dim=0))
    assert (c.flops, c.bytes) == (128, 4 * (128 + 8))
    # in place: read and written once
    z = torch.zeros(50)
    c, _ = counted(lambda: z.add_(1.0))
    assert (c.flops, c.bytes) == (50, 2 * 200)
    # views and allocations count nothing; a cast is a copy without FLOPs
    c, _ = counted(lambda: (grid[2:5].T, grid.view(8, 16), torch.empty(10)))
    assert (c.flops, c.bytes) == (0, 0)
    c, _ = counted(lambda: grid.double())
    assert (c.flops, c.bytes) == (0, 128 * 4 + 128 * 8)
    c, same = counted(lambda: grid.float().to("cpu"))  # nothing to do
    assert (c.flops, c.bytes, c.peak_bytes) == (0, 0, 0) and same is grid


def test_counter_index_ops_count_rows_touched():
    big = torch.randn(10_000, 16)
    idx = torch.tensor([3, 3, 9_000, 17], dtype=torch.int64)
    c, out = counted(lambda: big[idx])
    assert out.shape == (4, 16)
    assert (c.flops, c.bytes) == (0, 4 * 8 + 2 * 4 * 16 * 4)
    c, _ = counted(lambda: big.index_select(0, idx))
    assert c.bytes == 4 * 8 + 2 * 4 * 16 * 4
    acc = torch.zeros(10_000, 16)
    src = torch.randn(4, 16)
    c, _ = counted(lambda: acc.index_add_(0, idx, src))
    assert (c.flops, c.bytes) == (64, 4 * 8 + 64 * 4 + 2 * 64 * 4)
    cols = torch.arange(4)
    vals = torch.ones(4)
    c, _ = counted(lambda: acc.index_put_((idx, cols), vals, accumulate=True))
    assert (c.flops, c.bytes) == (4, 2 * 4 * 8 + 16 + 2 * 4 * 4)
    c, _ = counted(lambda: acc.index_put_((idx, cols), vals))
    assert (c.flops, c.bytes) == (0, 2 * 4 * 8 + 16 + 4 * 4)


def test_counter_tracks_live_memory():
    c = RA.OpCounter()
    with torch.inference_mode(), c:
        a = torch.zeros(1000)  # 4,000 B
        b = a + 1.0  # 4,000 B
        v = b[10:20]  # a view holds b's storage
        del a, b
        live_with_view = c.live_bytes
        del v
        live_after = c.live_bytes
    assert c.peak_bytes == 8000
    assert live_with_view == 4000 and live_after == 0


def test_meta_counts_equal_cpu_counts():
    """The counter's memo of meta kernels gives the same results as
    running them: a small chain of ops counts the same on both."""
    def chain(dev):
        x = torch.zeros(64, 32, device=dev)
        i = torch.zeros(100, dtype=torch.int64, device=dev)
        acc = torch.zeros(65, 32, device=dev)
        for _ in range(3):
            g = x[i.clamp(0, 63)]
            acc.index_add_(0, (i + 1).clamp(0, 64), g.float())
        return torch.topk(acc.sum(dim=1), 5)

    cc, (v, ix) = counted(lambda: chain("cpu"))
    cm, (vm, ixm) = counted(lambda: chain("meta"))
    assert cc.totals() == cm.totals()
    assert cc.peak_bytes == cm.peak_bytes
    assert (vm.shape, vm.dtype, ixm.dtype) == (v.shape, v.dtype, ix.dtype)


# ---------------------------------------------------------------------------
# The kernels' formulas
# ---------------------------------------------------------------------------


def _ell(n, k, rng):
    """A live-first ELL table: row v holds row_len[v] ids, then sentinel n."""
    row_len = rng.integers(0, k + 1, size=n).astype(np.int32)
    nbrs = np.full((n, k), n, np.int32)
    for v in range(n):
        nbrs[v, : row_len[v]] = rng.integers(0, n, size=row_len[v])
    return torch.from_numpy(nbrs), torch.from_numpy(row_len)


def _numpy_live(nbrs, row_len, n):
    a = nbrs.numpy()
    mask = (np.arange(a.shape[1])[None, :] < row_len.numpy()[:, None]) & (a < n)
    return int(mask.sum()), len(np.unique(a[mask]))


def _lane_args(n, k, w, rng, dev="cpu"):
    nbrs, row_len = _ell(n, k, rng)
    f = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
    i = lambda hi, s: torch.from_numpy(rng.integers(0, hi, s).astype(np.int32)).to(dev)
    fin = torch.from_numpy(rng.random(w) < 0.3).to(dev)
    return dict(nbrs=nbrs.to(dev), weights=f(n), table=f(n + 1, w), dep=f(n, w),
                total=f(n, w), fin=fin, u_p=i(n + 1, w), u_prev=i(n + 1, w),
                thr=f(w) * 0.1), row_len.to(dev)


@pytest.mark.parametrize("inplace", [False, True])
def test_lane_probe_counts_its_formula_once(inplace):
    n, k, w = 60, 9, 6
    a, row_len = _lane_args(n, k, w, RNG)
    live, distinct = _numpy_live(a["nbrs"], row_len, n)
    n_fin = int(a["fin"].sum())
    kw = dict(row_len=row_len, row0=0, tab0=0, n_live=n, prune=True)
    if inplace:
        kw["tot"] = a["total"]
    c, _ = counted(lambda: lane_probe_level(**a, **kw))
    want_bytes = (live * 4 + n * 8 + distinct * (w - n_fin) * 4 + n * n_fin * 4
                  + n * w * 4 * (1 if inplace else 3) + 4 * w * 4)
    want_flops = live * (w - n_fin) * 4 + n * w * 2
    assert (c.flops, c.bytes) == (want_flops, want_bytes)
    assert list(c.by_op) == ["lane_probe_level"] and c.by_op["lane_probe_level"][0] == 1
    meta = {x: y.to("meta") for x, y in a.items()}
    with pytest.raises(ValueError, match="meta"):
        counted(lambda: lane_probe_level(**meta, **dict(kw, row_len=row_len.to("meta"),
                                                        tot=None)))


def test_spmm_and_probe_push_count_their_formula_once():
    n, k, b = 70, 11, 5
    nbrs, row_len = _ell(n, k, RNG)
    live, distinct = _numpy_live(nbrs, row_len, n)
    w = torch.rand(n)
    scores = torch.rand(n, b)
    padded = torch.cat([scores, torch.zeros(1, b)])
    want = dict(flops=live * b + n * b,
                       bytes=live * 4 + n * 8 + distinct * b * 4 + n * b * 4)
    for call in (lambda: spmm_ell_padded(nbrs, padded, w, row_len=row_len),
                 lambda: spmm_ell(nbrs, scores, w, row_len=row_len)):
        c, _ = counted(call)
        assert dict(flops=c.flops, bytes=c.bytes) == want
        assert sum(r[0] for r in c.by_op.values()) == 1
    excl = torch.tensor([0, n, 5, 9, 3], dtype=torch.int32)
    c, _ = counted(lambda: probe_push(nbrs, scores, w, excl, prune_thresh=0.2,
                                      row_len=row_len))
    assert (c.flops, c.bytes) == (2 * live * b + n * b, want["bytes"] + b * 4)
    assert list(c.by_op) == ["probe_push"]
    with pytest.raises(ValueError, match="meta"):
        counted(lambda: spmm_ell_padded(nbrs.to("meta"), padded.to("meta"),
                                        w.to("meta"), row_len=row_len.to("meta")))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_counts_its_formula_on_cpu_and_meta(causal, dtype):
    B, S, H, Hkv, dh = 2, 12, 4, 2, 8
    q = torch.randn(B, S, H, dh).to(dtype)
    kv = torch.randn(B, S, Hkv, dh).to(dtype)
    c, out = counted(lambda: flash_attention(q, kv, kv, causal=causal))
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    item = q.element_size()
    assert c.flops == pairs * 4 * dh
    assert c.tc_flops == (c.flops if dtype == torch.bfloat16 else 0)
    assert c.bytes == item * (2 * q.numel() + 2 * kv.numel())
    before = flash_attention.launches
    qm, kvm = q.to("meta"), kv.to("meta")
    cm, mout = counted(lambda: flash_attention(qm, kvm, kvm, causal=causal))
    assert cm.totals() == c.totals()
    assert (mout.device.type, mout.shape, mout.dtype) == ("meta", out.shape, out.dtype)
    assert flash_attention.launches == before  # the meta route launches nothing
    with pytest.raises(ValueError, match="head width"):
        flash_attention(*(torch.empty(1, 4, 2, 130, device="meta"),) * 3)


# ---------------------------------------------------------------------------
# The mesh's exchanges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_exchanges_count_the_wire_bytes(s, wire):
    rows, w = 6, 5
    mesh = ShardMesh(["cpu"] * s)
    blocks = [torch.rand(rows, w) for _ in range(s)]
    c, full = counted(lambda: mesh.all_gather_rows(blocks, wire=wire))
    item = 2 if wire == "bfloat16" else 4
    assert c.collective_bytes["all-gather"] == (s - 1) * s * rows * w * item
    assert (c.flops, c.bytes) == (0, 0)  # nothing inside the exchange
    assert full[0].shape == (s * rows, w)
    c, shifted = counted(lambda: mesh.ring_shift(blocks))
    assert c.collective_bytes["collective-permute"] == (s > 1) * s * rows * w * 4
    assert c.collective_counts["collective-permute"] == 1
    assert shifted[0] is blocks[-1]
    # the same count when the blocks stand for distinct cards
    mblocks, mmesh = [b.to("meta") for b in blocks], ShardMesh(["meta"] * s)
    cm, _ = counted(lambda: mmesh.all_gather_rows(mblocks, wire=wire))
    assert cm.collective_bytes == counted(
        lambda: mesh.all_gather_rows(blocks, wire=wire))[0].collective_bytes
