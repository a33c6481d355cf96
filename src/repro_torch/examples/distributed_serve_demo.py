"""Distributed ProbeSim serving demo (port of
``examples/distributed_serve_demo.py``).

Runs the production serve step of the ``probesim`` family over a
``ShardMesh`` of row blocks — the all-gather push and the ring push with a
bf16 frontier — timing both and checking that they return the same top-k
sets.  By default the four blocks sit on the card; ``--device cpu`` runs
them on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.distributed_serve_demo
      [--device cpu] [--shards 4] [--nodes 20000 --edges 200000]
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs.base import ProbeSimConfig
from repro_torch.core.distributed import build_sharded_graph, make_serve_step
from repro_torch.core.ring import build_ring_graph, make_ring_serve_step
from repro_torch.core.walks import make_generator
from repro_torch.graph import powerlaw_graph
from repro_torch.launch.mesh import ShardMesh


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--edges", type=int, default=200_000)
    args = ap.parse_args(argv)

    mesh = ShardMesh([args.device] * args.shards)
    src, dst, n = powerlaw_graph(args.nodes, args.edges, seed=0)
    cfg = ProbeSimConfig(name="demo", n=n, m=len(src), c=0.6)
    Q, B, L, K = 4, 64, 8, 10
    queries = torch.tensor(np.unique(dst)[:Q], dtype=torch.int32)

    sg = build_sharded_graph(src, dst, n, mesh=mesh,
                             pad_nodes=math.lcm(32, args.shards),
                             pad_edges=256)
    rg = build_ring_graph(src, dst, n, mesh=mesh, csr=True)
    auto = make_serve_step(cfg, queries=Q, walk_chunk=B, max_len=L, top_k=K,
                           edge_chunks=4)
    ring = make_ring_serve_step(cfg, queries=Q, walk_chunk=B, max_len=L,
                                top_k=K, frontier_dtype=torch.bfloat16)
    print(f"graph n={n} m={len(src)} on {mesh}; {Q} queries x {B} walks, "
          f"{L - 1} levels")

    def run(fn, g):
        out = fn(g, queries, make_generator(0, mesh.home))
        if mesh.home.type == "cuda":
            torch.cuda.synchronize(mesh.home)
        return out

    answers = {}
    for name, fn, g in [("auto-partitioned", auto, sg),
                        ("ring+bf16       ", ring, rg)]:
        run(fn, g)  # warm-up
        t0 = time.perf_counter()
        for _ in range(3):
            idx, vals = run(fn, g)
        dt = (time.perf_counter() - t0) / 3
        answers[name] = idx.cpu().numpy()
        print(f"{name}: {dt * 1e3:7.1f} ms/step")
        for q in range(Q):
            print(f"  query {int(queries[q])}: top3={idx[q, :3].tolist()} "
                  f"scores={[round(float(v), 4) for v in vals[q, :3]]}")

    a_idx, r_idx = answers.values()
    same = all(set(a_idx[q].tolist()) == set(r_idx[q].tolist())
               for q in range(Q))
    print(f"top-{K} sets identical across implementations: {same}")
    return same


if __name__ == "__main__":
    main()
