"""Shared helpers of the tests that hold ``repro_torch`` against ``repro``.

Both packages meet on numpy arrays: JAX mirrors are turned into the port's
through ``repro_torch.graph.convert``, and JAX's walk uniforms are injected
into the port's fused serve step.
"""
import functools

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


@pytest.fixture
def one_thread():
    """Run the test's CPU steps on one intra-op thread.  The port's CPU
    tests are thousands of small ops: beside the other busy test workers
    each op waits on torch's thread pool (a file of them up to 20x slower
    than alone); the results do not depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_lm_cfg(jcfg):
    """The port's TransformerConfig with the fields of repro's ``jcfg``."""
    import dataclasses

    from repro_torch.configs.base import MoEConfig, TransformerConfig

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(fields["moe"]))
    return TransformerConfig(**fields)


@functools.lru_cache(maxsize=None)
def lm_pair(jcfg, seed=0):
    """repro's ``init_lm`` draws for ``jcfg`` (jitted: one compile, not one
    per op) and the port's ``LM`` copied from them on the CPU: (params,
    model, port config).  Cached: callers must not change them."""
    from repro.models.transformer import model as JM
    from repro_torch.models.transformer import model as TM

    params = jax.jit(JM.init_lm, static_argnums=1)(jax.random.key(seed), jcfg)
    tcfg = port_lm_cfg(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, TM.lm_from_params(tree, tcfg, device=CPU), tcfg


def bf16_params(params):
    """repro's fp32 LM params cast to bf16, routers kept in fp32 (the
    layout ``init_lm`` gives at ``param_dtype="bfloat16"``), as numpy."""
    def cast(path, a):
        a = np.asarray(a)
        key = getattr(path[-1], "key", None)
        return a if key == "router" else a.astype(jax.numpy.bfloat16)

    return jax.tree_util.tree_map_with_path(cast, params)


def int_tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def close_scaled(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    w = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(got.float().numpy(), w, atol=tol * scale, rtol=0)


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
