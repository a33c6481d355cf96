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
from repro.kernels.spmm_ell.ops import spmm_ell as j_spmm
from repro.kernels.spmm_ell.ops import spmm_ell_padded as j_spmm_padded
from repro_torch.kernels.lane_probe.ops import lane_probe_level as t_lane
from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref
from repro_torch.kernels.spmm_ell.ops import spmm_ell as t_spmm
from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded as t_spmm_padded
from repro_torch.kernels.spmm_ell.ref import spmm_ell_padded_ref, spmm_ell_ref
from torch_port_helpers import needs_cuda

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
    t_out, t_tot = t_lane(*targs, **kw)
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
    kw = dict(row0=0, tab0=0, n_live=50, prune=True)
    whole = lane_probe_level_ref(**lv, **kw)
    monkeypatch.setattr(ref, "GATHER_BUDGET_BYTES", 2 * 6 * 24 * 4)
    for a, b in zip(whole, lane_probe_level_ref(**lv, **kw)):
        assert torch.equal(a, b)


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors the wrappers are the plain versions and count no launch."""
    lv = {f: torch.from_numpy(np.array(v))
          for f, v in _level(np.random.default_rng(8)).items()}
    kw = dict(row0=0, tab0=0, n_live=50, prune=True)
    before = (t_lane.launches, t_spmm_padded.launches)
    for a, b in zip(t_lane(**lv, **kw), lane_probe_level_ref(**lv, **kw)):
        assert torch.equal(a, b)
    scores = torch.rand(51, 4)
    scores[50] = 0
    assert torch.equal(t_spmm_padded(lv["nbrs"], scores, lv["weights"]),
                       spmm_ell_padded_ref(lv["nbrs"], scores, lv["weights"]))
    assert (t_lane.launches, t_spmm_padded.launches) == before


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA never falls back to the plain
    version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_spmm_padded(torch.empty((4, 2), dtype=torch.int32, **meta),
                      torch.empty((5, 3), **meta), torch.empty(4, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        t_lane(torch.empty((4, 2), dtype=torch.int32, **meta),
               torch.empty(4, **meta), torch.empty((5, 3), **meta),
               torch.empty((4, 3), **meta), torch.empty((4, 3), **meta),
               torch.empty(3, dtype=torch.bool, **meta),
               torch.empty(3, dtype=torch.int32, **meta),
               torch.empty(3, dtype=torch.int32, **meta),
               torch.empty(3, **meta), row0=0, tab0=0, n_live=4, prune=False)


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
    out = t_spmm(torch.from_numpy(nbrs), torch.from_numpy(scores),
                 torch.from_numpy(weights))
    assert out.dtype == torch.from_numpy(scores).dtype
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)


def test_spmm_ell_untiled_shapes():
    """Shapes repro sends to its fallback (n % 128 != 0): the port has one
    path for every shape."""
    nbrs, scores, weights = _ell(np.random.default_rng(9), 100, 3, 8, np.float32)
    ref = np.asarray(j_spmm(jnp.asarray(nbrs), jnp.asarray(scores),
                            jnp.asarray(weights)))
    out = t_spmm(torch.from_numpy(nbrs), torch.from_numpy(scores),
                 torch.from_numpy(weights))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    vec = t_spmm(torch.from_numpy(nbrs), torch.from_numpy(scores[:, 0].copy()),
                 torch.from_numpy(weights))
    np.testing.assert_allclose(vec.numpy(), ref[:, 0], atol=1e-6)


def test_spmm_ell_padded_and_bf16():
    nbrs, scores, weights = _ell(np.random.default_rng(10), 128, 5, 16, np.float32)
    padded = np.concatenate([scores, np.zeros((1, 16), np.float32)])
    ref = np.asarray(j_spmm_padded(jnp.asarray(nbrs), jnp.asarray(padded),
                                   jnp.asarray(weights)))
    out = t_spmm_padded(torch.from_numpy(nbrs), torch.from_numpy(padded),
                        torch.from_numpy(weights))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    jb = np.asarray(j_spmm_padded(jnp.asarray(nbrs),
                                  jnp.asarray(padded, jnp.bfloat16),
                                  jnp.asarray(weights)), np.float32)
    tb = t_spmm_padded(torch.from_numpy(nbrs),
                       torch.from_numpy(padded).to(torch.bfloat16),
                       torch.from_numpy(weights))
    assert tb.dtype == torch.bfloat16
    np.testing.assert_allclose(tb.float().numpy(), jb, atol=2e-2, rtol=2e-2)


def test_spmm_ell_row_slice():
    """R < n rows against the full [n + 1, B] buffer (a slice of the table)."""
    nbrs, scores, weights = _ell(np.random.default_rng(11), 64, 5, 8, np.float32)
    scores = np.concatenate([scores, np.zeros((1, 8), np.float32)])
    full = spmm_ell_padded_ref(*map(torch.from_numpy, (nbrs, scores, weights)))
    part = t_spmm_padded(torch.from_numpy(nbrs[10:30].copy()),
                         torch.from_numpy(scores),
                         torch.from_numpy(weights[10:30].copy()))
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
    kw = dict(row0=0, tab0=0, n_live=n, prune=True)
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
    before = t_spmm_padded.launches
    out = t_spmm(*args)
    assert t_spmm_padded.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), spmm_ell_ref(*args).float(),
                               rtol=tol, atol=tol)
