"""repro_torch probe_push held against repro's.

On the CPU the port's op runs its plain version; repro's op runs its
Pallas kernel in interpret mode where its tiles fit (n % 128, B % 8) and
its plain reference elsewhere, as tests/test_kernels.py runs it.  Inputs
come from numpy with a seed.  fp32 agrees to 1e-5 (summation order);
bf16 storage within one bf16 step of outputs of order 1 (2e-2).  The
random tables put sentinels anywhere in a row, so they read every slot
(``row_len = K``); the live-first tables of the port's ``ell_from_edges``
read each row up to its in-degree.  The CUDA kernel is held against the
plain version on the card only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.probe_push.ops import probe_push as j_push
from repro.kernels.probe_push.ref import probe_push_ref as j_ref
import repro_torch.kernels.ell_plan as ell_plan
from repro_torch.graph import ell_from_edges, powerlaw_graph
from repro_torch.kernels.ell_plan import CHUNK_SLOTS
from repro_torch.kernels.probe_push.ops import probe_push as t_push
from repro_torch.kernels.probe_push.ref import probe_push_ref as t_ref
from torch_port_helpers import (
    close_to_plain,
    full_row_len,
    live_first_table,
    needs_cuda,
)


def _inputs(seed, n, K, B, *, sentinel_frac=0.3):
    """ELL table with some sentinels (id n), scores >= 0, weights, and an
    exclusion per column (some n: exclude nothing)."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, size=(n, K)).astype(np.int32)
    nbrs[rng.random((n, K)) < sentinel_frac] = n
    scores = np.abs(rng.normal(size=(n, B))).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    exclude = rng.integers(0, n + 1, size=B).astype(np.int32)
    return nbrs, scores, weights, exclude


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("n,K,B", [(128, 4, 8), (256, 9, 16), (100, 5, 3)])
@pytest.mark.parametrize("thresh", [0.0, 0.3])
def test_probe_push_matches_repro(n, K, B, thresh):
    arrays = _inputs(n + K + B, n, K, B)
    (jn, js, jw, je), (tn, ts, tw, te) = _both(arrays)
    out = t_push(tn, ts, tw, te, prune_thresh=thresh, row_len=full_row_len(tn))
    assert out.dtype == torch.float32 and out.shape == (n, B)
    for want in (j_push(jn, js, jw, je, prune_thresh=thresh),
                 j_ref(jn, js, jw, je, prune_thresh=thresh)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_probe_push_exclusion_sentinels_and_threshold():
    n, K, B = 128, 6, 8
    nbrs, scores, weights, _ = _inputs(11, n, K, B)
    scores += 0.1
    nbrs[5] = n  # a row of nothing but sentinels
    nbrs[6, :3] = n + 7  # ids past the sentinel read the zero row too
    exclude = (np.arange(B) * 7).astype(np.int32)
    exclude[3] = n  # column 3 excludes nothing
    (jn, js, jw, je), (tn, ts, tw, te) = _both((nbrs, scores, weights, exclude))
    full = full_row_len(tn)
    out = t_push(tn, ts, tw, te, row_len=full).numpy()
    np.testing.assert_allclose(out, np.asarray(j_ref(jn, js, jw, je)), atol=1e-5)
    for b in range(B):
        assert (out[b * 7, b] == 0.0) == (b != 3)
    assert (out[5] == 0.0).all()
    # a threshold above every score prunes everything
    top = float(scores.max()) + 1.0
    assert (t_push(tn, ts, tw, te, prune_thresh=top, row_len=full) == 0).all()


def test_probe_push_bf16_matches_repro_in_fp32():
    """bf16 storage: the port sums in fp32 and rounds once; repro's
    reference on the same (bf16-representable) values in fp32."""
    n, K, B = 96, 5, 12
    nbrs, scores, weights, exclude = _inputs(12, n, K, B)
    scores_bf = torch.from_numpy(scores).to(torch.bfloat16)
    exact = scores_bf.float().numpy()
    tn = torch.from_numpy(nbrs)
    out = t_push(tn, scores_bf, torch.from_numpy(weights),
                 torch.from_numpy(exclude), prune_thresh=0.5, row_len=full_row_len(tn))
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_ref(jnp.asarray(nbrs), jnp.asarray(exact), jnp.asarray(weights),
                            jnp.asarray(exclude), prune_thresh=0.5))
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# Live-first tables read up to row_len = in_deg (the kernel's row extent)
# ---------------------------------------------------------------------------


def _hub_graph(B=16, seed=31):
    """The port's ELL table of a power-law graph whose hub row is longer
    than CHUNK_SLOTS (live slots first), scores >= 0, weights, and
    exclusions: column 0 on the hub row, column 1 none, the rest random."""
    src, dst, n = powerlaw_graph(384, 1500, seed=5)
    eg = ell_from_edges(src, dst, n, device="cpu")
    deg = eg.in_deg.numpy()
    hub = int(deg.argmax())
    assert deg[hub] > CHUNK_SLOTS
    rng = np.random.default_rng(seed)
    scores = np.abs(rng.normal(size=(n, B))).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    exclude = rng.integers(0, n, size=B).astype(np.int32)
    exclude[0], exclude[1] = hub, n
    return eg, hub, scores, weights, exclude


@pytest.mark.parametrize("thresh", [0.0, 0.6])
def test_probe_push_row_extent_matches_repro(thresh):
    eg, hub, scores, weights, exclude = _hub_graph()
    nbrs = eg.in_nbrs.numpy()
    (jn, js, jw, je), (tn, ts, tw, te) = _both((nbrs, scores, weights, exclude))
    out = t_push(tn, ts, tw, te, prune_thresh=thresh, row_len=eg.in_deg)
    want = np.asarray(j_push(jn, js, jw, je, prune_thresh=thresh))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    assert out[hub, 0] == 0.0 and out[hub, 1:].abs().sum() > 0


def test_probe_push_cut_row_extent_is_honoured():
    """row_len shorter than the live prefix: the slots past it are not
    read, i.e. equal repro's reference on a table whose cut slots hold the
    sentinel."""
    eg, _, scores, weights, exclude = _hub_graph(B=8, seed=32)
    n = eg.n
    nbrs = eg.in_nbrs.numpy()
    cut = eg.in_deg // 2
    masked = np.where(np.arange(nbrs.shape[1])[None, :] < cut.numpy()[:, None],
                      nbrs, n).astype(np.int32)
    assert (masked != nbrs).any()
    args = [torch.from_numpy(a) for a in (nbrs, scores, weights, exclude)]
    want = np.asarray(j_ref(*[jnp.asarray(a) for a in (masked, scores, weights, exclude)],
                            prune_thresh=0.3))
    out = t_push(*args, prune_thresh=0.3, row_len=cut)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    full = t_push(*args, prune_thresh=0.3, row_len=eg.in_deg)
    assert not torch.allclose(full, out)


def test_probe_push_row_extent_bf16_matches_repro_in_fp32():
    eg, hub, scores, weights, exclude = _hub_graph(B=12, seed=33)
    scores_bf = torch.from_numpy(scores).to(torch.bfloat16)
    out = t_push(eg.in_nbrs, scores_bf, torch.from_numpy(weights),
                 torch.from_numpy(exclude), prune_thresh=0.5, row_len=eg.in_deg)
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_ref(jnp.asarray(eg.in_nbrs.numpy()),
                            jnp.asarray(scores_bf.float().numpy()),
                            jnp.asarray(weights), jnp.asarray(exclude),
                            prune_thresh=0.5))
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=2e-2)
    assert out[hub, 0] == 0


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,B,thresh", [
    (128, 4, 8, 0.0), (300, 9, 70, 0.3), (33, 700, 300, 0.5), (7, 3, 1, 0.0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_push_kernel_on_card(n, K, B, thresh, dtype):
    needs_cuda()
    nbrs, scores, weights, exclude = (torch.from_numpy(a).cuda()
                                      for a in _inputs(13, n, K, B))
    scores = scores.to(dtype)
    full = full_row_len(nbrs)
    before = t_push.launches
    out = t_push(nbrs, scores, weights, exclude, prune_thresh=thresh, row_len=full)
    assert t_push.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), t_ref(nbrs, scores, weights, exclude, thresh, row_len=full).float(),
        atol=tol, rtol=tol)


def _card_push(rng, b, dtype):
    """A live-first table (hub row 600 over several pieces, rows of 0, C,
    C + 1 and 2C + 3 slots) on the card, scores >= 0, and exclusions, some
    negative (row 0) and some >= n (none): column 0 on the hub row, the
    last column (B > 1) on the 2C + 3 row 601, column 1 (B > 2) none."""
    n, k = 1200, 1100
    nbrs, deg = live_first_table(rng, n, k)
    exclude = rng.integers(-2, n + 3, b).astype(np.int32)  # some < 0, some >= n
    exclude[-1] = n // 2 + 1
    exclude[0] = n // 2
    if b > 2:
        exclude[1] = n
    args = [torch.from_numpy(nbrs).cuda(),
            torch.from_numpy(rng.random((n, b)).astype(np.float32)).cuda().to(dtype),
            torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32)).cuda(),
            torch.from_numpy(exclude).cuda()]
    return args, torch.from_numpy(deg).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 63, 64, 257])
@pytest.mark.parametrize("chunk", [64, 128])
def test_probe_push_kernel_split_rows(dtype, b, chunk, monkeypatch):
    """Split rows at two chunk sizes, every B shape of the layout, an
    exclusion on a split row (applied once, by the row's last block)."""
    needs_cuda()
    rng = np.random.default_rng(60 + b + chunk)
    args, row_len = _card_push(rng, b, dtype)
    monkeypatch.setattr(ell_plan, "CHUNK_SLOTS", chunk)
    for thresh in (0.0, 0.5):
        before = t_push.launches
        out = t_push(*args, prune_thresh=thresh, row_len=row_len)
        assert t_push.launches == before + 1
        close_to_plain(out, t_ref(*args, thresh, row_len=row_len), dtype)
        assert out[600, 0] == 0 and (b == 1 or out[601, -1] == 0)
        assert b == 1 or float(out[600].float().abs().sum()) > 0


@pytest.mark.cuda
def test_probe_push_kernel_repeats_bit_for_bit(monkeypatch):
    """Two launches on the same inputs give the same bits: split rows are
    summed in piece order, not by float atomics."""
    needs_cuda()
    rng = np.random.default_rng(70)
    args, row_len = _card_push(rng, 256, torch.float32)
    monkeypatch.setattr(ell_plan, "CHUNK_SLOTS", 32)
    a = t_push(*args, prune_thresh=0.2, row_len=row_len)
    b = t_push(*args, prune_thresh=0.2, row_len=row_len)
    assert torch.equal(a, b)
