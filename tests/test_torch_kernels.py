"""repro_torch kernels: the plain versions held against repro's ops, and the
CUDA kernels held against the plain versions (card only).

On the CPU each wrapper runs its plain version; repro's ops run their
Pallas kernels in interpret mode, as repro's own tests do.  fp32 agrees to
1e-5 (summation order); bf16 storage to 1e-3 (the bound repro uses).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.lane_probe.ops import lane_probe_level as j_lane
from repro.kernels.lane_probe.ref import lane_probe_level_ref as j_lane_ref
from repro.kernels.spmm_ell.ops import spmm_ell as j_spmm
from repro.kernels.spmm_ell.ops import spmm_ell_padded as j_spmm_padded
from repro.kernels.spmm_ell.ref import spmm_ell_ref as j_spmm_ref
import repro_torch.kernels.ell_plan as ell_plan
from repro_torch.kernels.ell_plan import (
    CACHED_PLANS,
    CHUNK_SLOTS,
    build_plan,
    clear_plans,
    launch_layout,
    plan_of,
)
from repro_torch.kernels.lane_probe.ops import lane_probe_level as t_lane
from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref
from repro_torch.kernels.spmm_ell.ops import spmm_ell as t_spmm
from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded as t_spmm_padded
from repro_torch.kernels.spmm_ell.ref import spmm_ell_padded_ref, spmm_ell_ref
from torch_port_helpers import (
    close_to_plain,
    full_row_len,
    live_first_table,
    needs_cuda,
    port_handle,
)

FIELDS = ("nbrs", "weights", "table", "dep", "total", "fin", "u_p", "u_prev",
          "thr")


def _level(rng, *, n=50, k=6, w=24, t=None, n_live=None):
    """A random compacted-lane level (numpy): some finished columns, some
    injections, some sentinel neighbors."""
    t = (n + 1) if t is None else t
    n_live = n if n_live is None else n_live
    return dict(
        nbrs=rng.integers(0, n_live + 1, (n, k)).astype(np.int32),
        weights=rng.random(n).astype(np.float32),
        table=rng.random((t, w)).astype(np.float32),
        dep=rng.random((n, w)).astype(np.float32),
        total=rng.random((n, w)).astype(np.float32),
        fin=rng.random(w) < 0.4,
        u_p=np.where(rng.random(w) < 0.5, rng.integers(0, n, w), n_live
                     ).astype(np.int32),
        u_prev=np.where(rng.random(w) < 0.5, rng.integers(0, n, w), n_live
                        ).astype(np.int32),
        thr=(rng.random(w) * 0.3).astype(np.float32),
    )


def _run_both(lv, *, row0=0, tab0=0, n_live, prune, bf16=False):
    """(port out, port tot, repro out, repro tot) as float32 numpy."""
    store = ("table", "dep", "total")
    jargs = [jnp.asarray(lv[f]) for f in FIELDS]
    targs = [torch.from_numpy(np.array(lv[f])) for f in FIELDS]
    if bf16:
        jargs = [a.astype(jnp.bfloat16) if f in store else a
                 for f, a in zip(FIELDS, jargs)]
        targs = [a.to(torch.bfloat16) if f in store else a
                 for f, a in zip(FIELDS, targs)]
    kw = dict(row0=row0, tab0=tab0, n_live=n_live, prune=prune)
    t_out, t_tot = t_lane(*targs, row_len=full_row_len(targs[0]), **kw)
    j_out, j_tot = j_lane(*jargs, **kw)
    want = torch.bfloat16 if bf16 else torch.float32
    assert t_out.dtype == t_tot.dtype == want
    return (t_out.float().numpy(), t_tot.float().numpy(),
            np.asarray(j_out, np.float32), np.asarray(j_tot, np.float32))


def _check(lv, **kw):
    t_out, t_tot, j_out, j_tot = _run_both(lv, **kw)
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_tot, j_tot, rtol=1e-5, atol=1e-6)
    return t_out, t_tot


# ---------------------------------------------------------------------------
# lane_probe plain version vs repro (mirrors tests/test_lane_kernel.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prune", [False, True])
def test_lane_probe_matches_repro(prune):
    out, _ = _check(_level(np.random.default_rng(1)), n_live=50, prune=prune)
    assert np.abs(out).sum() > 0


def test_lane_probe_offset_addressing():
    """row0/tab0: spmd (tab0 = row0, full frontier) and ring (tab0 = 0, own
    block) layouts."""
    lv = _level(np.random.default_rng(2), n=40, t=120, w=16, n_live=120)
    _check(lv, row0=40, tab0=40, n_live=120, prune=True)
    _check(lv, row0=80, tab0=0, n_live=120, prune=False)


def test_lane_probe_all_lanes_dead():
    n, w = 30, 12
    lv = _level(np.random.default_rng(3), n=n, w=w)
    lv["fin"] = np.ones(w, bool)
    lv["u_p"] = np.full(w, n, np.int32)
    out, tot = _check(lv, n_live=n, prune=False)
    assert (out == 0).all()
    np.testing.assert_allclose(tot, lv["total"] + lv["dep"], rtol=1e-7)


def test_lane_probe_single_active_column():
    n, w = 30, 9
    lv = _level(np.random.default_rng(4), n=n, w=w)
    lv["fin"] = np.ones(w, bool)
    lv["fin"][4] = False
    out, _ = _check(lv, n_live=n, prune=True)
    assert np.abs(out[:, 4]).sum() > 0
    dead = np.delete(np.arange(w), 4)
    inj = np.delete(lv["u_p"], 4) < n
    assert ((np.abs(out[:, dead]).sum(axis=0) > 0) == inj).all()


def test_lane_probe_sentinel_row():
    n = 30
    lv = _level(np.random.default_rng(5), n=n, w=8)
    lv["nbrs"][7] = n
    lv["u_prev"] = np.full(8, n, np.int32)
    out, _ = _check(lv, n_live=n, prune=False)
    assert (out[7] == 0).all()


@pytest.mark.parametrize("n,w", [(30, 37), (130, 24), (7, 128), (5, 300)])
def test_lane_probe_awkward_shapes(n, w):
    _check(_level(np.random.default_rng(n + w), n=n, w=w), n_live=n, prune=True)


@pytest.mark.parametrize("prune", [False, True])
def test_lane_probe_bf16_storage(prune):
    """bf16 storage, fp32 accumulation: within 1e-3 of repro's bf16 level."""
    t_out, t_tot, j_out, j_tot = _run_both(
        _level(np.random.default_rng(6)), n_live=50, prune=prune, bf16=True)
    assert np.abs(t_out - j_out).max() <= 1e-3
    assert np.abs(t_tot - j_tot).max() <= 1e-3


def test_lane_probe_plain_chunks(monkeypatch):
    """The plain version's row chunking (a byte budget of two rows) does not
    change its answer."""
    from repro_torch.kernels.lane_probe import ref

    lv = {f: torch.from_numpy(np.array(v))
          for f, v in _level(np.random.default_rng(7)).items()}
    kw = dict(row0=0, tab0=0, n_live=50, prune=True, row_len=full_row_len(lv["nbrs"]))
    whole = lane_probe_level_ref(**lv, **kw)
    monkeypatch.setattr(ref, "GATHER_BUDGET_BYTES", 2 * 6 * 24 * 4)
    for a, b in zip(whole, lane_probe_level_ref(**lv, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("kernel", ["lane_probe", "spmm_ell"])
def test_plain_chunks_cut_at_hubs_keep_the_sums(monkeypatch, kernel, device):
    """``row_chunks`` starts a new chunk where a hub row would widen its
    neighbours' rows past twice their live slots plus CHUNK_WASTE_BYTES
    (the card's 8 MB, or the CPU's 0: a cut at every such row).  On a table
    of short rows and hubs of 1,024 slots, 64 lanes, the chunks differ from
    the budget-only chunking (no waste limit) and both plain ELL versions
    agree within the kernel checks' fp32 tolerance: a zero slot adds
    nothing, but torch may group a row's additions by its chunk's extent,
    so the bits may differ."""
    from repro_torch.kernels.spmm_ell import ref as spmm_ref

    rng = np.random.default_rng(11)
    n, k, w = 400, 1024, 64
    deg = rng.integers(0, 6, n).astype(np.int32)
    deg[[37, 150, 151, 320]] = [k, k, 700, k]
    nbrs = np.full((n, k), n, np.int32)
    for v in np.flatnonzero(deg):
        nbrs[v, : deg[v]] = rng.integers(0, n, deg[v])
    lv = {f: torch.from_numpy(np.array(v))
          for f, v in _level(rng, n=n, k=k, w=w).items()}
    lv["nbrs"] = torch.from_numpy(nbrs)
    row_len = torch.from_numpy(deg)
    scores = torch.rand(n + 1, w, generator=torch.Generator().manual_seed(11))
    scores[n] = 0

    def run():
        chunks = list(spmm_ref.row_chunks(row_len, k, w * 4, spmm_ref.GATHER_BUDGET_BYTES))
        if kernel == "lane_probe":
            out = lane_probe_level_ref(**lv, row_len=row_len, row0=0, tab0=0, n_live=n,
                                       prune=True)
        else:
            out = (spmm_ell_padded_ref(lv["nbrs"], scores, lv["weights"], row_len=row_len),)
        return chunks, out

    waste = spmm_ref.CHUNK_WASTE_BYTES
    monkeypatch.setitem(waste, "cpu", waste[device])
    cut_chunks, cut = run()
    monkeypatch.setitem(waste, "cpu", float("inf"))
    whole_chunks, whole = run()
    assert len(whole_chunks) == 1 and len(cut_chunks) > 2
    for a, b in zip(cut, whole, strict=True):
        close_to_plain(a, b, torch.float32)


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors the wrappers are the plain versions and count no launch."""
    lv = {f: torch.from_numpy(np.array(v))
          for f, v in _level(np.random.default_rng(8)).items()}
    full = full_row_len(lv["nbrs"])
    kw = dict(row0=0, tab0=0, n_live=50, prune=True, row_len=full)
    before = (t_lane.launches, t_spmm_padded.launches)
    for a, b in zip(t_lane(**lv, **kw), lane_probe_level_ref(**lv, **kw)):
        assert torch.equal(a, b)
    scores = torch.rand(51, 4)
    scores[50] = 0
    assert torch.equal(
        t_spmm_padded(lv["nbrs"], scores, lv["weights"], row_len=full),
        spmm_ell_padded_ref(lv["nbrs"], scores, lv["weights"], row_len=full))
    assert (t_lane.launches, t_spmm_padded.launches) == before


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA never falls back to the plain
    version."""
    meta = dict(device="meta")
    row_len = torch.empty(4, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        t_spmm_padded(torch.empty((4, 2), dtype=torch.int32, **meta),
                      torch.empty((5, 3), **meta), torch.empty(4, **meta),
                      row_len=row_len)
    with pytest.raises(ValueError, match="no kernel"):
        t_lane(torch.empty((4, 2), dtype=torch.int32, **meta),
               torch.empty(4, **meta), torch.empty((5, 3), **meta),
               torch.empty((4, 3), **meta), torch.empty((4, 3), **meta),
               torch.empty(3, dtype=torch.bool, **meta),
               torch.empty(3, dtype=torch.int32, **meta),
               torch.empty(3, dtype=torch.int32, **meta),
               torch.empty(3, **meta), row_len=row_len, row0=0, tab0=0,
               n_live=4, prune=False)


# ---------------------------------------------------------------------------
# spmm_ell plain version vs repro (mirrors tests/test_kernels.py:28,39)
# ---------------------------------------------------------------------------


def _ell(rng, n, k, b, dtype):
    nbrs = rng.integers(0, n + 1, size=(n, k)).astype(np.int32)
    scores = rng.normal(size=(n, b)).astype(dtype)
    weights = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    return nbrs, scores, weights


@pytest.mark.parametrize("n,k,b", [(128, 4, 8), (256, 7, 16), (384, 16, 32)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_spmm_ell_matches_repro(n, k, b, dtype):
    nbrs, scores, weights = _ell(np.random.default_rng(n + k), n, k, b, dtype)
    ref = np.asarray(j_spmm(jnp.asarray(nbrs), jnp.asarray(scores),
                            jnp.asarray(weights)), np.float32)
    tn = torch.from_numpy(nbrs)
    out = t_spmm(tn, torch.from_numpy(scores), torch.from_numpy(weights),
                 row_len=full_row_len(tn))
    assert out.dtype == torch.from_numpy(scores).dtype
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


def test_spmm_ell_untiled_shapes():
    """Shapes repro sends to its fallback (n % 128 != 0): the port has one
    path for every shape."""
    nbrs, scores, weights = _ell(np.random.default_rng(9), 100, 3, 8, np.float32)
    ref = np.asarray(j_spmm(jnp.asarray(nbrs), jnp.asarray(scores),
                            jnp.asarray(weights)))
    tn = torch.from_numpy(nbrs)
    out = t_spmm(tn, torch.from_numpy(scores), torch.from_numpy(weights),
                 row_len=full_row_len(tn))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    vec = t_spmm(tn, torch.from_numpy(scores[:, 0].copy()),
                 torch.from_numpy(weights), row_len=full_row_len(tn))
    np.testing.assert_allclose(vec.numpy(), ref[:, 0], atol=1e-6)


def test_spmm_ell_padded_and_bf16():
    nbrs, scores, weights = _ell(np.random.default_rng(10), 128, 5, 16, np.float32)
    padded = np.concatenate([scores, np.zeros((1, 16), np.float32)])
    ref = np.asarray(j_spmm_padded(jnp.asarray(nbrs), jnp.asarray(padded),
                                   jnp.asarray(weights)))
    full = full_row_len(torch.from_numpy(nbrs))
    out = t_spmm_padded(torch.from_numpy(nbrs), torch.from_numpy(padded),
                        torch.from_numpy(weights), row_len=full)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    jb = np.asarray(j_spmm_padded(jnp.asarray(nbrs),
                                  jnp.asarray(padded, jnp.bfloat16),
                                  jnp.asarray(weights)), np.float32)
    tb = t_spmm_padded(torch.from_numpy(nbrs),
                       torch.from_numpy(padded).to(torch.bfloat16),
                       torch.from_numpy(weights), row_len=full)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_allclose(tb.float().numpy(), jb, atol=2e-2, rtol=2e-2)


def test_spmm_ell_row_slice():
    """R < n rows against the full [n + 1, B] buffer (a slice of the table)."""
    nbrs, scores, weights = _ell(np.random.default_rng(11), 64, 5, 8, np.float32)
    scores = np.concatenate([scores, np.zeros((1, 8), np.float32)])
    lens = full_row_len(torch.from_numpy(nbrs))
    full = spmm_ell_padded_ref(*map(torch.from_numpy, (nbrs, scores, weights)),
                               row_len=lens)
    part = t_spmm_padded(torch.from_numpy(nbrs[10:30].copy()),
                         torch.from_numpy(scores),
                         torch.from_numpy(weights[10:30].copy()),
                         row_len=lens[10:30].clone())
    assert torch.equal(part, full[10:30])


# ---------------------------------------------------------------------------
# The CUDA kernels against the plain versions (skip without a card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,w", [(50, 24), (130, 300)])
def test_lane_probe_kernel_on_card(bf16, n, w):
    needs_cuda()
    lv = _level(np.random.default_rng(12), n=n, w=w)
    dtype = torch.bfloat16 if bf16 else torch.float32
    args = {f: torch.from_numpy(np.array(v)).cuda() for f, v in lv.items()}
    for f in ("table", "dep", "total"):
        args[f] = args[f].to(dtype)
    kw = dict(row0=0, tab0=0, n_live=n, prune=True, row_len=full_row_len(args["nbrs"]))
    before = t_lane.launches
    out = t_lane(**args, **kw)
    assert t_lane.launches == before + 1
    ref = lane_probe_level_ref(**args, **kw)
    tol = 2 ** -7 if bf16 else 1e-5
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_spmm_ell_kernel_on_card(dtype):
    needs_cuda()
    nbrs, scores, weights = _ell(np.random.default_rng(13), 300, 9, 70, np.float32)
    args = [torch.from_numpy(x).cuda() for x in (nbrs, scores, weights)]
    args[1] = args[1].to(dtype)
    full = full_row_len(args[0])
    before = t_spmm_padded.launches
    out = t_spmm(*args, row_len=full)
    assert t_spmm_padded.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(),
                               spmm_ell_ref(*args, row_len=full).float(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Row extent and chunk plan (kernels/ell_plan.py)
# ---------------------------------------------------------------------------

GRAPHS = ("toy", "small_powerlaw")


def _plan_rows(plan):
    """{row: slots in the order the kernel sums them} from the plan's
    chunks; also checks each chunk against the plan's shared-memory
    bounds."""
    chunks = plan.chunks.tolist()
    short_rows, short_ptr = plan.short_rows.tolist(), plan.short_ptr.tolist()
    long_rows, long_first = plan.long_rows.tolist(), plan.long_first.tolist()
    seen, pieces = {}, {}
    kinds = [c[0] for c in chunks]
    assert kinds == sorted(kinds, key=lambda x: x == 0), "split chunks first"
    for kind, a, b, p in chunks:
        if kind == 0:
            assert 0 < b - a <= plan.max_rows
            assert short_ptr[b] - short_ptr[a] <= plan.max_slots
            for i in range(a, b):
                seen.setdefault(short_rows[i], []).append(
                    list(range(short_ptr[i + 1] - short_ptr[i])))
        else:
            assert 0 < b - a <= plan.chunk_slots <= plan.max_slots
            pieces.setdefault(kind - 1, []).append((p, a, b))
    for l, ps in pieces.items():
        ps.sort()
        assert [p for p, _, _ in ps] == list(range(long_first[l], long_first[l + 1]))
        seen.setdefault(long_rows[l], []).append(
            [k for _, a, b in ps for k in range(a, b)])
    return seen


@pytest.mark.parametrize("chunk_slots", [8, CHUNK_SLOTS])
def test_plan_covers_every_slot_once_in_order(chunk_slots):
    """Zero-length rows, a hub row over many pieces, rows of exactly C and
    C + 1 slots, rows past k_max and negative lengths."""
    c = chunk_slots
    rng = np.random.default_rng(20)
    k_max = 5 * c + 7
    lens = rng.integers(0, 6, 300)
    lens[[0, 1, 57, 299]] = 0
    lens[[10, 11, 12]] = [c, c + 1, 5 * c + 7]  # the last one: the hub row
    lens[13], lens[14] = k_max + 40, -3          # clamped to [0, k_max]
    row_len = torch.from_numpy(lens.astype(np.int32))
    plan = build_plan(row_len, k_max, chunk_slots=c)
    seen = _plan_rows(plan)
    assert sorted(seen) == list(range(300))
    for v, visits in seen.items():
        assert len(visits) == 1, f"row {v} in {len(visits)} chunks"
        assert visits[0] == list(range(min(max(int(lens[v]), 0), k_max)))
    assert plan.n_long == (np.clip(lens, 0, k_max) > c).sum()
    # a packed chunk's cost stays under one chunk plus its last row
    short = np.clip(lens, 0, k_max)[np.clip(lens, 0, k_max) <= c]
    assert plan.max_rows <= -(-c // 4) + 1 and plan.max_slots <= 2 * c
    assert plan.short_ptr[-1] == short.sum()


@pytest.mark.parametrize("lens", [[], [0, 0, 0], [9, 9], [0, 20, 0]])
def test_plan_edge_row_sets(lens):
    """No rows, only empty rows, only long rows, long rows between empties."""
    row_len = torch.tensor(lens, dtype=torch.int32)
    plan = build_plan(row_len, 20, chunk_slots=4)
    seen = _plan_rows(plan)
    assert sorted(seen) == list(range(len(lens)))
    assert all(v[0] == list(range(lens[r])) for r, v in seen.items())


def test_plan_cache_and_check(small_powerlaw, monkeypatch):
    """plan_of builds once per row_len tensor and row range (a new view of
    the same rows finds the plan), builds anew for other memory, another
    table width or chunk size and after an in-place write, and keeps at most
    CACHED_PLANS plans."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    deg, k = h.eg.in_deg, h.k_max
    clear_plans()
    before = build_plan.builds
    p = plan_of(deg, k)
    assert plan_of(deg, k) is p and build_plan.builds == before + 1
    part = plan_of(deg[10:60], k)
    assert part is not p and tuple(part.row_len.shape) == (50,)
    assert plan_of(deg[10:60], k) is part and build_plan.builds == before + 2
    assert plan_of(deg.clone(), k) is not p
    assert plan_of(deg, k + 1).k_max == k + 1
    with monkeypatch.context() as m:
        m.setattr(ell_plan, "CHUNK_SLOTS", 8)
        assert plan_of(deg, k).chunk_slots == 8
    assert plan_of(deg, k) is p and build_plan.builds == before + 5
    deg[3] += 0  # an in-place write bumps the version
    assert plan_of(deg, k) is not p and build_plan.builds == before + 6
    for i in range(2 * CACHED_PLANS):
        plan_of(deg[i:], k)
    assert len(ell_plan._plans) == CACHED_PLANS
    clear_plans()
    assert not ell_plan._plans


@pytest.mark.parametrize("width,itemsize,want", [
    (256, 4, (4, 64, 1)), (64, 4, (4, 16, 1)), (1, 4, (1, 1, 1)),
    (63, 4, (1, 64, 1)), (257, 4, (1, 256, 2)), (256, 2, (8, 32, 1)),
    (2048, 4, (4, 256, 2)), (6, 2, (2, 4, 1)),
])
def test_launch_layout(width, itemsize, want):
    assert launch_layout(width, itemsize, 0, 4096) == want


def test_launch_layout_follows_alignment():
    """A row pointer 8 bytes off a 16-byte boundary halves the vector."""
    assert launch_layout(256, 4, 0, 8) == (2, 128, 1)
    assert launch_layout(256, 4, 4) == (1, 256, 1)


def _fixture_level(rng, d, w=24):
    n = d["n"]
    return dict(
        nbrs=np.asarray(d["eg"].in_nbrs), weights=rng.random(n).astype(np.float32),
        table=rng.random((n + 1, w)).astype(np.float32),
        dep=rng.random((n, w)).astype(np.float32),
        total=rng.random((n, w)).astype(np.float32),
        fin=rng.random(w) < 0.4,
        u_p=np.where(rng.random(w) < 0.5, rng.integers(0, n, w), n).astype(np.int32),
        u_prev=np.where(rng.random(w) < 0.5, rng.integers(0, n, w), n).astype(np.int32),
        thr=(rng.random(w) * 0.3).astype(np.float32),
    )


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("prune", [False, True])
def test_lane_probe_row_extent_matches_repro_ref(request, name, prune):
    """row_len = in_deg on the fixture's ELL table == repro's
    lane_probe_level_ref over all K slots (live slots come first)."""
    d = request.getfixturevalue(name)
    n = d["n"]
    lv = _fixture_level(np.random.default_rng(21), d)
    kw = dict(row0=0, tab0=0, n_live=n, prune=prune)
    j_out, j_tot = j_lane_ref(*[jnp.asarray(lv[f]) for f in FIELDS], **kw)
    targs = {f: torch.from_numpy(np.array(lv[f])) for f in FIELDS}
    row_len = torch.from_numpy(np.array(d["eg"].in_deg))
    t_out, t_tot = lane_probe_level_ref(**targs, row_len=row_len, **kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_tot.numpy(), np.asarray(j_tot), rtol=1e-5, atol=1e-6)
    assert np.abs(t_out.numpy()).sum() > 0


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("b", [None, 1, 7])
def test_spmm_ell_row_extent_matches_repro_ref(request, name, b):
    d = request.getfixturevalue(name)
    n = d["n"]
    rng = np.random.default_rng(22)
    scores = rng.normal(size=(n,) if b is None else (n, b)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    ref = np.asarray(j_spmm_ref(d["eg"].in_nbrs, jnp.asarray(scores), jnp.asarray(w)))
    out = spmm_ell_ref(torch.from_numpy(np.array(d["eg"].in_nbrs)),
                       torch.from_numpy(scores), torch.from_numpy(w),
                       row_len=torch.from_numpy(np.array(d["eg"].in_deg)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_cut_row_extent_is_honoured(small_powerlaw):
    """A row_len that cuts live slots: both plain versions (and the CPU
    wrappers) read only slots k < row_len[v], i.e. equal repro's refs on a
    table whose cut slots hold the sentinel."""
    d = small_powerlaw
    n = d["n"]
    nbrs = np.array(d["eg"].in_nbrs)
    deg = np.array(d["eg"].in_deg)
    cut = (deg // 2).astype(np.int32)
    masked = np.where(np.arange(nbrs.shape[1])[None, :] < cut[:, None], nbrs, n)
    assert (masked != nbrs).any()
    row_len = torch.from_numpy(cut)
    lv = _fixture_level(np.random.default_rng(23), d)
    kw = dict(row0=0, tab0=0, n_live=n, prune=False)
    jl = dict(lv, nbrs=masked.astype(np.int32))
    j_out, _ = j_lane_ref(*[jnp.asarray(jl[f]) for f in FIELDS], **kw)
    targs = {f: torch.from_numpy(np.array(lv[f])) for f in FIELDS}
    for fn in (lane_probe_level_ref, t_lane):
        t_out, _ = fn(**targs, row_len=row_len, **kw)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5,
                                   atol=1e-6)
    full, _ = t_lane(**targs, row_len=torch.from_numpy(deg), **kw)
    assert not torch.allclose(full, t_out)
    scores = np.random.default_rng(24).normal(size=(n, 5)).astype(np.float32)
    w = np.ones(n, np.float32)
    ref = np.asarray(j_spmm_ref(jnp.asarray(masked), jnp.asarray(scores),
                                jnp.asarray(w)))
    for fn in (spmm_ell_ref, t_spmm):
        out = fn(torch.from_numpy(nbrs), torch.from_numpy(scores),
                 torch.from_numpy(w), row_len=row_len)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_lane_probe_destinations(small_powerlaw):
    """out= / tot= (tot may be total itself) give the allocating call's
    values; out= overlapping an input and tot= overlapping the table
    raise."""
    d = small_powerlaw
    n = d["n"]
    lv = {f: torch.from_numpy(np.array(v))
          for f, v in _fixture_level(np.random.default_rng(25), d).items()}
    kw = dict(row0=0, tab0=0, n_live=n, prune=True,
              row_len=torch.from_numpy(np.array(d["eg"].in_deg)))
    want_out, want_tot = t_lane(**lv, **kw)
    buf = torch.full((n + 1, 24), 7.0)
    total = lv["total"].clone()
    out, tot = t_lane(**dict(lv, total=total), **kw, out=buf[:n], tot=total)
    assert out.data_ptr() == buf.data_ptr() and tot is total
    assert torch.equal(out, want_out) and torch.equal(tot, want_tot)
    assert (buf[n] == 7.0).all()
    with pytest.raises(ValueError, match="out= overlaps table"):
        t_lane(**lv, **kw, out=lv["table"][:n])
    with pytest.raises(ValueError, match="out= overlaps total"):
        t_lane(**lv, **kw, out=lv["total"])
    with pytest.raises(ValueError, match="tot= overlaps table"):
        t_lane(**lv, **kw, tot=lv["table"][1:])
    with pytest.raises(ValueError, match="must be contiguous"):
        t_lane(**lv, **kw, out=torch.empty((24, n)).T)


# ---------------------------------------------------------------------------
# The redesigned kernels on the card: row extent, split rows, determinism
# ---------------------------------------------------------------------------


def _card_level(rng, nbrs, deg, w, dtype, *, row0=0, t=None):
    n_all = nbrs.shape[0] if t is None else t
    r = nbrs.shape[0]
    lv = dict(
        nbrs=torch.from_numpy(nbrs), weights=torch.from_numpy(rng.random(r).astype(np.float32)),
        table=torch.from_numpy(rng.random((n_all + 1, w)).astype(np.float32)),
        dep=torch.from_numpy(rng.random((r, w)).astype(np.float32)),
        total=torch.from_numpy(rng.random((r, w)).astype(np.float32)),
        fin=torch.from_numpy(rng.random(w) < 0.4),
        u_p=torch.from_numpy(rng.integers(row0, row0 + r, w).astype(np.int32)),
        u_prev=torch.from_numpy(rng.integers(row0, row0 + r, w).astype(np.int32)),
        thr=torch.from_numpy((rng.random(w) * 0.3).astype(np.float32)),
    )
    lv = {f: x.cuda() for f, x in lv.items()}
    for f in ("table", "dep", "total"):
        lv[f] = lv[f].to(dtype)
    return lv, torch.from_numpy(deg).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [1, 63, 64, 256, 257])
def test_lane_probe_kernel_row_extent(dtype, w, monkeypatch):
    """Hub row over several pieces, empty rows, rows of C and C + 1 slots,
    and a cut row extent; default and small chunks."""
    needs_cuda()
    rng = np.random.default_rng(30 + w)
    nbrs, deg = live_first_table(rng, 1200, 1100)
    lv, row_len = _card_level(rng, nbrs, deg, w, dtype)
    kw = dict(row0=0, tab0=0, n_live=1200, prune=True)
    cut = row_len // 2
    for lens, chunk in ((row_len, CHUNK_SLOTS), (row_len, 64), (cut, CHUNK_SLOTS)):
        monkeypatch.setattr(ell_plan, "CHUNK_SLOTS", chunk)
        before = t_lane.launches
        out, tot = t_lane(**lv, row_len=lens, **kw)
        assert t_lane.launches == before + 1
        ref_out, ref_tot = lane_probe_level_ref(**lv, row_len=lens, **kw)
        close_to_plain(out, ref_out, dtype)
        close_to_plain(tot, ref_tot, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_probe_kernel_row_slices(dtype):
    """row0/tab0: a slice holding the hub row against the full frontier
    (tab0 = row0) and against its own block (tab0 = 0)."""
    needs_cuda()
    rng = np.random.default_rng(31)
    n = 1200
    nbrs, deg = live_first_table(rng, n, 1100)
    row0, r = 500, 300  # holds the hub row n // 2
    lv, row_len = _card_level(rng, nbrs[row0:row0 + r].copy(), deg[row0:row0 + r].copy(),
                              64, dtype, row0=row0, t=n)
    for tab0, table in ((row0, lv["table"]), (0, lv["table"][:r].contiguous())):
        kw = dict(row0=row0, tab0=tab0, n_live=n, prune=tab0 == 0)
        args = dict(lv, table=table)
        out, tot = t_lane(**args, row_len=row_len, **kw)
        ref_out, ref_tot = lane_probe_level_ref(**args, row_len=row_len, **kw)
        close_to_plain(out, ref_out, dtype)
        close_to_plain(tot, ref_tot, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 63, 64, 257])
def test_spmm_ell_kernel_row_extent(dtype, b, monkeypatch):
    needs_cuda()
    rng = np.random.default_rng(40 + b)
    n, k = 1200, 1100
    nbrs, deg = live_first_table(rng, n, k)
    args = [torch.from_numpy(nbrs).cuda(),
            torch.from_numpy(rng.random((n + 1, b)).astype(np.float32)).cuda().to(dtype),
            torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32)).cuda()]
    args[1][n] = 0
    row_len = torch.from_numpy(deg).cuda()
    for lens, chunk in ((row_len, CHUNK_SLOTS), (row_len, 64),
                        (row_len // 3, CHUNK_SLOTS)):
        monkeypatch.setattr(ell_plan, "CHUNK_SLOTS", chunk)
        before = t_spmm_padded.launches
        out = t_spmm_padded(*args, row_len=lens)
        assert t_spmm_padded.launches == before + 1
        close_to_plain(out, spmm_ell_padded_ref(*args, row_len=lens), dtype)
    monkeypatch.undo()
    part = t_spmm_padded(args[0][590:610].contiguous(), args[1],
                         args[2][590:610].contiguous(), row_len=row_len[590:610])
    close_to_plain(part, spmm_ell_padded_ref(*args, row_len=row_len)[590:610], dtype)


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit(monkeypatch):
    """The same inputs twice give the same bits: split rows are summed in
    piece order, not by float atomics."""
    needs_cuda()
    rng = np.random.default_rng(50)
    nbrs, deg = live_first_table(rng, 1200, 1100)
    lv, row_len = _card_level(rng, nbrs, deg, 256, torch.float32)
    monkeypatch.setattr(ell_plan, "CHUNK_SLOTS", 32)
    kw = dict(row0=0, tab0=0, n_live=1200, prune=False, row_len=row_len)
    a = t_lane(**lv, **kw)
    b = t_lane(**lv, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    scores = lv["table"][:, :64].contiguous()
    scores[1200] = 0
    s1 = t_spmm_padded(lv["nbrs"], scores, lv["weights"], row_len=row_len)
    s2 = t_spmm_padded(lv["nbrs"], scores, lv["weights"], row_len=row_len)
    assert torch.equal(s1, s2)


@pytest.mark.cuda
def test_lane_probe_kernel_in_place():
    """tot= total itself and out= a second buffer give the allocating
    call's bits; the buffer's extra row stays untouched."""
    needs_cuda()
    rng = np.random.default_rng(51)
    nbrs, deg = live_first_table(rng, 1200, 1100)
    lv, row_len = _card_level(rng, nbrs, deg, 256, torch.float32)
    kw = dict(row0=0, tab0=0, n_live=1200, prune=True, row_len=row_len)
    want_out, want_tot = t_lane(**lv, **kw)
    buf = torch.zeros((1201, 256), device="cuda")
    total = lv["total"].clone()
    t_lane(**dict(lv, total=total), **kw, out=buf[:1200], tot=total)
    assert torch.equal(buf[:1200], want_out) and torch.equal(total, want_tot)
    assert bool((buf[1200] == 0).all())
