"""The general traffic generator: every mix is a parameter file under
``traffic/`` that this module and the mix's entry read.

A mix names its ``entry`` (the loop under ``entries/`` that drives the
program), its query width and walk geometry, and how many whole units the
check compares.  Query nodes are drawn uniformly from the nodes with an
in-neighbour.  All draws come from ``--seed`` through numpy
``SeedSequence`` streams, so the same seed gives the same queries and
walk seeds however the window cuts them.
"""
from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def stream(seed: int, *path: int) -> np.random.Generator:
    """A numpy generator for stream ``path`` of ``seed`` (any integer)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & MASK64, *path]))


def walk_seed(seed: int, *path: int) -> int:
    """A 63-bit torch seed for stream ``path`` of ``seed``."""
    words = np.random.SeedSequence([int(seed) & MASK64, *path]).generate_state(
        2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)


# stream ids
QUERIES, WARM, SAMPLE, GRAPH = 1, 2, 5, 6


class QueryStream:
    """Query nodes drawn uniformly from ``candidates``, with one walk seed
    each; query i is the same in every run of a seed."""

    def __init__(self, seed: int, candidates: np.ndarray, which: int = QUERIES):
        self.seed, self.which = int(seed), which
        self.rng = stream(seed, which)
        self.candidates = np.asarray(candidates, np.int64)
        self.count = 0

    def take(self, q: int) -> tuple[list[int], list[int], int]:
        """The next ``q`` queries: (nodes, walk seeds, index of the first)."""
        nodes = self.candidates[self.rng.integers(0, len(self.candidates), q)]
        first = self.count
        seeds = [walk_seed(self.seed, self.which, first + i) for i in range(q)]
        self.count += q
        return [int(x) for x in nodes], seeds, first
