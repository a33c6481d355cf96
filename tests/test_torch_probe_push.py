"""repro_torch probe_push held against repro's.

On the CPU the port's op runs its plain version; repro's op runs its
Pallas kernel in interpret mode where its tiles fit (n % 128, B % 8) and
its plain reference elsewhere, as tests/test_kernels.py runs it.  Inputs
come from numpy with a seed.  fp32 agrees to 1e-5 (summation order);
bf16 storage within one bf16 step of outputs of order 1 (2e-2).  The CUDA
kernel is held against the plain version on the card only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.probe_push.ops import probe_push as j_push
from repro.kernels.probe_push.ref import probe_push_ref as j_ref
from repro_torch.kernels.probe_push.ops import probe_push as t_push
from repro_torch.kernels.probe_push.ref import probe_push_ref as t_ref
from torch_port_helpers import needs_cuda


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
    out = t_push(tn, ts, tw, te, prune_thresh=thresh)
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
    out = t_push(tn, ts, tw, te).numpy()
    np.testing.assert_allclose(out, np.asarray(j_ref(jn, js, jw, je)), atol=1e-5)
    for b in range(B):
        assert (out[b * 7, b] == 0.0) == (b != 3)
    assert (out[5] == 0.0).all()
    # a threshold above every score prunes everything
    top = float(scores.max()) + 1.0
    assert (t_push(tn, ts, tw, te, prune_thresh=top) == 0).all()


def test_probe_push_bf16_matches_repro_in_fp32():
    """bf16 storage: the port sums in fp32 and rounds once; repro's
    reference on the same (bf16-representable) values in fp32."""
    n, K, B = 96, 5, 12
    nbrs, scores, weights, exclude = _inputs(12, n, K, B)
    scores_bf = torch.from_numpy(scores).to(torch.bfloat16)
    exact = scores_bf.float().numpy()
    out = t_push(torch.from_numpy(nbrs), scores_bf, torch.from_numpy(weights),
                 torch.from_numpy(exclude), prune_thresh=0.5)
    assert out.dtype == torch.bfloat16
    want = np.asarray(j_ref(jnp.asarray(nbrs), jnp.asarray(exact), jnp.asarray(weights),
                            jnp.asarray(exclude), prune_thresh=0.5))
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=2e-2)


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
    before = t_push.launches
    out = t_push(nbrs, scores, weights, exclude, prune_thresh=thresh)
    assert t_push.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), t_ref(nbrs, scores, weights, exclude, thresh).float(),
        atol=tol, rtol=tol)
