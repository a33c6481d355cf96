"""Shared helpers of the tests that hold ``repro_torch`` against ``repro``.

Both packages meet on numpy arrays: JAX mirrors are turned into the port's
through ``repro_torch.graph.convert``, and JAX's walk uniforms are injected
into the port's fused serve step.
"""
import numpy as np
import pytest
import torch

import jax

from repro_torch.kernels.ell_plan import CHUNK_SLOTS

CPU = "cpu"


def port_handle(jg, jeg):
    """The port's GraphHandle (on the CPU) from a JAX (Graph, EllGraph) pair."""
    from repro_torch.graph.convert import handle_from_arrays

    return handle_from_arrays(
        src=np.asarray(jg.src), dst=np.asarray(jg.dst),
        in_nbrs=np.asarray(jeg.in_nbrs), in_deg=np.asarray(jeg.in_deg),
        out_deg=np.asarray(jg.out_deg), num_edges=int(jg.num_edges),
        n=jg.n, version=int(jg.version), overflow=bool(jg.overflow),
        device=CPU,
    )


def jax_uniforms(keys, *, n_r, max_len, sqrt_c):
    """JAX's per-query walk draws ([Q, n_r, max_len - 1] each) as tensors."""
    from repro.core.walks import walk_uniforms

    cont, pick = jax.vmap(
        lambda k: walk_uniforms(k, n_r=n_r, max_len=max_len, sqrt_c=sqrt_c)
    )(keys)
    return (torch.from_numpy(np.array(cont)), torch.from_numpy(np.array(pick)))


def needs_cuda():
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with `python -m pytest -m cuda`")


def full_row_len(nbrs):
    """row_len reading every slot: the random tables of the tests put
    sentinels anywhere in a row, as repro's own kernel tests do."""
    return torch.full((nbrs.shape[0],), nbrs.shape[1], dtype=torch.int32,
                      device=nbrs.device)


def live_first_table(rng, n, k, c=CHUNK_SLOTS):
    """An [n, k] ELL table with live slots first: short rows, empty rows, a
    hub row of k slots (several pieces), rows of exactly c and c + 1."""
    deg = rng.integers(0, 6, n).astype(np.int32)
    deg[[3, 9, n - 1]] = 0
    deg[[10, 11, n // 2, n // 2 + 1]] = [c, c + 1, k, 2 * c + 3]
    nbrs = np.full((n, k), n, np.int32)
    for v in np.flatnonzero(deg):
        nbrs[v, : deg[v]] = rng.integers(0, n, deg[v])
    return nbrs, deg


def close_to_plain(out, ref, dtype):
    """fp32: 1e-5 of the row sum (the plain version's terms are >= 0 here,
    so the row sum is the output itself); bf16/fp16: one step."""
    o, r = out.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-6)
        return
    bits = 7 if dtype == torch.bfloat16 else 10
    step = torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=1e-30))) - bits)
    bad = (o - r).abs() > torch.maximum(step, torch.full_like(step, 1e-6))
    assert not bool(bad.any()), float((o - r).abs().max())
