"""Shared helpers of the tests that hold ``repro_torch`` against ``repro``.

Both packages meet on numpy arrays: JAX mirrors are turned into the port's
through ``repro_torch.graph.convert``, and JAX's walk uniforms are injected
into the port's fused serve step.
"""
import numpy as np
import pytest
import torch

import jax

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
