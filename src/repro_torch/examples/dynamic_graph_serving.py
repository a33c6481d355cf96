"""End-to-end driver (the paper's deployment story, port of
``examples/dynamic_graph_serving.py``): serve batched top-k SimRank
queries on a DYNAMIC graph with fused update->query session epochs.

Each ``SimRankSession.epoch()`` applies a padded batch of edge insertions
and deletions to both device mirrors (owned by the session's
``GraphHandle``, written in place) and serves a batch of queries on the
just-updated graph, with no host transfer between update and query and no
index rebuild.  Every result is stamped with the graph ``version`` it was
computed against and the Thm-1 error bound at the walk budget spent, and a
capacity overflow regrows the buffers without losing updates.

``--backend sharded`` runs the same loop on the sharded backend: the
updates are applied block by block to the device-resident shard buffers
and the probe runs over the ``ShardMesh`` (``--shards`` blocks: one per
card for ``--device cuda``, all on ``--device`` otherwise).

Run:  PYTHONPATH=src python -m repro_torch.examples.dynamic_graph_serving
      [--device cpu] [--backend sharded --shards 4] [--nodes N --edges M]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import GraphHandle, SimRankSession
from repro_torch.graph import powerlaw_graph
from repro_torch.launch.mesh import mesh_for


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("local", "sharded"),
                    default="local")
    ap.add_argument("--shards", type=int, default=None,
                    help="row-partition count for --backend sharded "
                         "(default: the CUDA device count)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--edges", type=int, default=None)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    quick = args.backend == "sharded"  # the mesh loop runs small
    n_nodes, n_edges = (1_000, 12_000) if quick else (5_000, 60_000)
    n_nodes = args.nodes or n_nodes
    n_edges = args.edges or n_edges
    src, dst, n = powerlaw_graph(n_nodes, n_edges, seed=0, max_deg=512)
    in_deg = np.bincount(dst, minlength=n)
    handle = GraphHandle.from_edges(
        src, dst, n,
        capacity=len(src) + 10_000,  # headroom for the insert stream
        k_max=int(in_deg.max()) + 64,
        device=args.device,
    )
    mesh = (mesh_for(args.device, args.shards) if args.backend == "sharded"
            else None)
    sess = SimRankSession(
        handle, c=0.6, eps_a=0.1, top_k=10,
        batch_q=4, update_batch=64, walk_chunk=256, seed=0,
        backend=args.backend, mesh=mesh,
    )
    print(f"graph n={n} m={len(src)}; n_r={sess.params.n_r} walks/query; "
          f"epoch = {sess.update_batch} update ops + "
          f"{sess.batch_q} queries; backend={sess.backend.name}"
          + (f" mesh={mesh}" if mesh is not None else ""))

    queries = rng.choice(np.where(in_deg > 0)[0], 12)
    for i in range(3):
        # one epoch: a 60-insert burst + a few deletions of original edges
        # + 4 queries, fused into one update->query step
        sess.queue_update(rng.integers(0, n, 60).astype(np.int32),
                          rng.integers(0, n, 60).astype(np.int32))
        sess.queue_update(src[i * 4:i * 4 + 4], dst[i * 4:i * 4 + 4],
                          insert=False)
        ep = sess.epoch(queries=[int(u) for u in queries[i * 4:(i + 1) * 4]],
                        budget_walks=512)
        print(f"epoch {i}: v{ep.version} "
              f"updates {ep.updates_applied}/{ep.updates_submitted} applied"
              f"{' (overflow->regrown)' if ep.regrown else ''}, "
              f"{len(ep.results)} queries in {ep.latency_s:.2f}s "
              f"(err bound {ep.results[0].error_bound:.3f} @512 walks)")
        for res in ep.results[:2]:
            print(f"  u={res.node} @v{res.version} "
                  f"top3={[int(v) for v in res.topk_nodes[:3]]} "
                  f"scores={[round(float(s), 4) for s in res.topk_scores[:3]]}")
    s = sess.stats
    print(f"served {s.queries} queries across {s.epochs} epochs, "
          f"{s.updates} edge updates applied, {s.regrows} regrows — "
          f"zero index rebuilds (index-free)")


if __name__ == "__main__":
    main()
