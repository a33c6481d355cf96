"""repro_torch walk sampling: given repro's uniforms, bit-identical walks.

torch and JAX draw different numbers from one seed, so the seam is
``walks_from_uniforms``: fed JAX's ``(cont, pick)`` it must return JAX's
walks exactly (``floor(pick * deg)`` in float32 on both sides).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import walks as jw
from repro_torch.core import walks as tw
from torch_port_helpers import port_handle


@pytest.mark.parametrize("name", ["toy", "small_powerlaw"])
@pytest.mark.parametrize("u,sqrt_c,max_len", [(0, 0.5, 6), (3, 0.77, 12)])
def test_walks_from_uniforms_bitwise(request, key, name, u, sqrt_c, max_len):
    d = request.getfixturevalue(name)
    h = port_handle(d["g"], d["eg"])
    cont, pick = jw.walk_uniforms(key, n_r=200, max_len=max_len, sqrt_c=sqrt_c)
    ref = np.asarray(jw.walks_from_uniforms(d["eg"], u, cont, pick))
    out = tw.walks_from_uniforms(h.eg, u, torch.from_numpy(np.array(cont)),
                                 torch.from_numpy(np.array(pick)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tw.walk_lengths(out, d["n"]).numpy(),
        np.asarray(jw.walk_lengths(jnp.asarray(ref), d["n"])),
    )


def test_pool_from_jax_uniforms_bitwise(small_powerlaw, key):
    """A whole multi-query pool (per-row sources) equals JAX's vmapped
    sampler under the same per-query keys."""
    d = small_powerlaw
    h = port_handle(d["g"], d["eg"])
    us = np.array([3, 11, 0], np.int32)
    keys = jax.random.split(key, 3)
    ref = np.asarray(jw.sample_walks_batch(keys, d["eg"], jnp.asarray(us), n_r=50,
                                           max_len=9, sqrt_c=0.77))
    cont, pick = jax.vmap(
        lambda k: jw.walk_uniforms(k, n_r=50, max_len=9, sqrt_c=0.77))(keys)
    out = tw.walks_from_uniforms(
        h.eg, torch.from_numpy(us).repeat_interleave(50),
        torch.from_numpy(np.array(cont)).reshape(150, 8),
        torch.from_numpy(np.array(pick)).reshape(150, 8),
    )
    np.testing.assert_array_equal(out.numpy().reshape(3, 50, 9), ref)


def test_walk_structure(small_powerlaw):
    """Walks start at u, follow in-edges, and stay at the sentinel once dead."""
    d = small_powerlaw
    h = port_handle(d["g"], d["eg"])
    n = d["n"]
    walks = tw.sample_walks(tw.make_generator(5, "cpu"), h.eg, 7, n_r=300,
                            max_len=10, sqrt_c=0.77).numpy()
    assert walks.shape == (300, 10) and (walks[:, 0] == 7).all()
    edges = set(zip(d["src"].tolist(), d["dst"].tolist()))
    dead = walks >= n
    assert (dead[:, :-1] <= dead[:, 1:]).all()  # sentinel is absorbing
    for row in walks:
        live = row[row < n]
        for a, b in zip(live[:-1], live[1:]):
            assert (b, a) in edges  # b is an in-neighbor of a


def test_batch_equals_single_queries(small_powerlaw):
    """Query q's walks depend only on its own generator."""
    h = port_handle(small_powerlaw["g"], small_powerlaw["eg"])
    seeds = [11, 12, 13]
    batch = tw.sample_walks_batch(
        [tw.make_generator(s, "cpu") for s in seeds], h.eg, [3, 11, 3],
        n_r=40, max_len=8, sqrt_c=0.77)
    for i, (s, u) in enumerate(zip(seeds, [3, 11, 3])):
        solo = tw.sample_walks(tw.make_generator(s, "cpu"), h.eg, u, n_r=40,
                               max_len=8, sqrt_c=0.77)
        np.testing.assert_array_equal(batch[i].numpy(), solo.numpy())


def test_uniforms_and_seeds():
    a = tw.walk_uniforms(tw.make_generator(3, "cpu"), n_r=5, max_len=4, sqrt_c=0.5)
    b = tw.walk_uniforms(tw.make_generator(3, "cpu"), n_r=5, max_len=4, sqrt_c=0.5)
    assert a[0].dtype == torch.bool and a[1].dtype == torch.float32
    assert a[0].shape == a[1].shape == (5, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    seeds = {tw.derive_seed(0, i) for i in range(100)} | {tw.derive_seed(1, 0)}
    assert len(seeds) == 101 and all(0 <= s < 2**63 for s in seeds)
    assert tw.derive_seed(4, 2) == tw.derive_seed(4, 2)
