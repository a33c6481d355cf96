import numpy as np
import pytest

import jax

from repro.graph import ell_from_edges, graph_from_edges, toy_graph


@pytest.fixture(scope="session")
def toy():
    src, dst, n = toy_graph()
    return dict(
        src=src,
        dst=dst,
        n=n,
        g=graph_from_edges(src, dst, n),
        eg=ell_from_edges(src, dst, n),
    )


@pytest.fixture(scope="session")
def small_powerlaw():
    from repro.graph import powerlaw_graph

    src, dst, n = powerlaw_graph(200, 1500, seed=3)
    return dict(
        src=src,
        dst=dst,
        n=n,
        g=graph_from_edges(src, dst, n),
        eg=ell_from_edges(src, dst, n),
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.key(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (CUDA kernels of repro_torch); skips "
        "when torch.cuda.is_available() is false",
    )
