"""repro_torch's host CSR (``graph/structs.py``: ``CsrGraph``,
``csr_from_edges``) and GNN neighbour sampler (``graph/sampler.py``),
pinned numpy copies of repro's: equal arrays on the same edges and seeds
(repro's ``tests/test_graph.py::test_sampler_shapes_and_validity`` is the
model), and every live sampled edge a real in-edge."""
import numpy as np
import pytest

from repro.graph import csr_from_edges as j_csr
from repro.graph import powerlaw_graph
from repro.graph.sampler import block_shapes as j_block_shapes
from repro.graph.sampler import sample_blocks as j_sample

from repro_torch.graph import CsrGraph, csr_from_edges
from repro_torch.graph.sampler import SampledBlocks, block_shapes, sample_blocks
from torch_port_helpers import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def edges():
    src, dst, n = powerlaw_graph(200, 1500, seed=3)
    # two isolated nodes past the generator's ids: rows with no in-edge
    return src, dst, n + 2


@pytest.mark.parametrize("by", ["dst", "src"])
def test_csr_from_edges_equals_repro(edges, by):
    src, dst, n = edges
    t, j = csr_from_edges(src, dst, n, by=by), j_csr(src, dst, n, by=by)
    assert isinstance(t, CsrGraph) and (t.n, t.m) == (j.n, j.m)
    for name in ("indptr", "indices"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.degree(), j.degree())
    for v in (0, 7, n - 1):
        np.testing.assert_array_equal(t.neighbors(v), j.neighbors(v))


@pytest.mark.parametrize("batch,fanouts", [(8, (3, 2)), (1024, (15, 10)), (5, (4,))])
def test_block_shapes_equal_repro(batch, fanouts):
    assert block_shapes(batch, fanouts) == j_block_shapes(batch, fanouts)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_blocks_equal_repro(edges, seed):
    src, dst, n = edges
    csr = csr_from_edges(src, dst, n)
    seeds = np.random.default_rng(seed).choice(n, 8, replace=False).astype(np.int32)
    seeds[-1] = n - 1  # an isolated seed: its branch is sentinel-padded
    t = sample_blocks(csr, seeds, (3, 2), np.random.default_rng(seed))
    j = j_sample(j_csr(src, dst, n), seeds, (3, 2), np.random.default_rng(seed))
    assert isinstance(t, SampledBlocks)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    for name in ("edge_src", "edge_dst", "edge_mask"):
        for a, b in zip(getattr(t, name), getattr(j, name), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (t.seed_count, t.frontier_sizes) == (j.seed_count, j.frontier_sizes)
    shapes = block_shapes(8, (3, 2))
    assert t.nodes.shape[0] == shapes["table"]
    assert not t.edge_mask[0][-3:].any()  # the isolated seed's samples
    for h in range(2):
        live = t.edge_mask[h]
        for sp, dp in zip(t.edge_src[h][live], t.edge_dst[h][live]):
            assert t.nodes[sp] in csr.neighbors(int(t.nodes[dp]))
