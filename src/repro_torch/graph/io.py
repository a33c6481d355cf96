"""Edge-list IO (SNAP text format and a fast binary format); copy of
``repro.graph.io``, pinned equal by ``tests/test_torch_production.py``.
Pure numpy.  The cache directory defaults to ``repro_cache`` under the
process's temporary directory (``tempfile.gettempdir()``, which honours
``TMPDIR``); ``REPRO_CACHE`` overrides it, as in the reference."""
from __future__ import annotations

import os
import tempfile

import numpy as np


def read_edgelist(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse a SNAP-style whitespace edge list ('# ' comments allowed).

    Node ids are compacted to [0, n).
    """
    srcs: list[int] = []
    dsts: list[int] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            parts = line.split()
            srcs.append(int(parts[0]))
            dsts.append(int(parts[1]))
    src = np.asarray(srcs, dtype=np.int64)
    dst = np.asarray(dsts, dtype=np.int64)
    uniq, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    m = len(src)
    return inv[:m].astype(np.int32), inv[m:].astype(np.int32), len(uniq)


def write_edgelist(path: str, src: np.ndarray, dst: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# src dst\n")
        for s, d in zip(src.tolist(), dst.tolist()):
            f.write(f"{s} {d}\n")


def save_graph_npz(path: str, src: np.ndarray, dst: np.ndarray, n: int) -> None:
    np.savez_compressed(path, src=src.astype(np.int32), dst=dst.astype(np.int32), n=n)


def load_graph_npz(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    z = np.load(path)
    return z["src"], z["dst"], int(z["n"])


def cache_dir() -> str:
    d = os.environ.get("REPRO_CACHE",
                       os.path.join(tempfile.gettempdir(), "repro_cache"))
    os.makedirs(d, exist_ok=True)
    return d
