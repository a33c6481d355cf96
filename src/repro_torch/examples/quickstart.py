"""Quickstart: the session API on the paper's Figure-1 toy graph (port of
``examples/quickstart.py``).

One ``GraphHandle`` owns both mirrors; one ``SimRankSession`` serves every
query shape (single-source vectors, top-k lists, fused batches) and every
update (immediate or fused update->query epochs).  Estimates are checked
against the port's Power Method (Table 2); one leg serves the graph cut
into two destination row blocks (``backend="sharded"``), and the last leg
serves it over HTTP.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(the default device is the card).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import GraphHandle, QuerySpec, SimRankSession
from repro_torch.core import simrank_power
from repro_torch.graph import TOY_TABLE2, toy_graph

NAMES = "abcdefgh"


def _named(nodes, scores) -> list:
    return [(NAMES[i], round(float(s), 4)) for i, s in zip(nodes, scores)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    src, dst, n = toy_graph()
    handle = GraphHandle.from_edges(src, dst, n, device=dev)  # COO + ELL

    # the paper's example uses decay c' = 0.25
    sess = SimRankSession(handle, c=0.25, eps_a=0.05, delta=0.01,
                          top_k=3, batch_q=3, seed=0)
    p = sess.params
    print(f"ProbeSim params: n_r={p.n_r} walks, l_t={p.max_len}, "
          f"eps={p.eps:.3f} eps_p={p.eps_p:.4f} eps_t={p.eps_t:.3f}")

    env = sess.query(QuerySpec(kind="single_source", node=0))
    truth = simrank_power(handle.g, c=0.25, iters=60).cpu().numpy()[0]

    print(f"\n{'node':>5} {'ProbeSim':>9} {'truth':>9} {'Table2':>7}")
    for i, ch in enumerate(NAMES):
        print(f"{ch:>5} {env.scores[i]:9.4f} {truth[i]:9.4f} "
              f"{TOY_TABLE2[ch]:7.4f}")
    err = np.abs(env.scores - truth)[1:].max()
    print(f"\nmax abs error = {err:.4f}  (envelope bound: "
          f"<= {env.error_bound:.4f} w.p. >= {1 - p.delta}, "
          f"variant={env.variant})")
    if not err <= env.error_bound:
        raise RuntimeError(f"error {err} above the bound {env.error_bound}")

    tk = sess.query(QuerySpec(kind="topk", node=0, k=3))
    print("top-3 similar to 'a':", _named(tk.topk_nodes, tk.topk_scores))

    # --- batched serving (the fused path) ---------------------------------
    # queued specs share one fused step: pooled walk sampling, one probe
    # level for the whole batch per launch, per-query reduction + top-k.
    # Seeds are fixed at submit time, so batch composition never changes an
    # answer.
    for u in (0, 2, 4):  # a, c, e
        sess.submit(u)
    for res in sess.drain():  # one fused dispatch for the whole batch
        print(f"fused top-3 for '{NAMES[res.node]}':",
              _named(res.topk_nodes, res.topk_scores))

    # --- dynamic epochs: fused update -> query, no index rebuild ----------
    # one epoch writes a padded edge-update batch into both mirrors and
    # serves the query batch on the just-updated graph; results carry the
    # graph `version` they were computed against.  capacity/k_max reserve
    # headroom for insertions (overflow is flagged and auto-regrown, never
    # silently dropped)
    hd = GraphHandle.from_edges(src, dst, n, capacity=len(src) + 8, k_max=8,
                                device=dev)
    dsess = SimRankSession(hd, c=0.25, eps_a=0.05, top_k=3,
                           batch_q=2, update_batch=4, seed=0)
    ep = dsess.epoch(inserts=([5, 5], [0, 1]),  # f->a, f->b: new paths
                     queries=[0, 2])  # update + query, one epoch
    print(f"epoch: {ep.updates_applied} updates applied -> "
          f"graph v{ep.version}")
    for res in ep.results:
        print(f"dynamic top-3 for '{NAMES[res.node]}' @v{res.version}:",
              _named(res.topk_nodes, res.topk_scores))
    if not all(res.version == 1 for res in ep.results):
        raise RuntimeError("epoch results do not see the update")
    print(f"session stats: {dsess.stats}")

    # --- pluggable backends: the same surface, sharded --------------------
    # backend="sharded" places a dst-partitioned copy of the graph in row
    # blocks over a ShardMesh (here both blocks on one device; a machine
    # with several cards passes ShardMesh(shards=N), one block per card).
    # submit() returns a QueryTicket on every backend: poll()/result() for
    # async consumption, drain() stays the synchronous collect-all.
    from repro_torch.launch.mesh import ShardMesh

    ssess = SimRankSession(handle, c=0.25, eps_a=0.05, top_k=3, seed=0,
                           backend="sharded", mesh=ShardMesh([dev] * 2))
    ticket = ssess.submit(0)
    env = ticket.result(budget_walks=2048)
    print(f"sharded top-3 for 'a' ({env.variant}):",
          _named(env.topk_nodes, env.topk_scores))
    ssess.update(inserts=([5], [0]))  # shard-wise apply, no index rebuild
    if ssess.version != 1:
        raise RuntimeError("the sharded update did not bump the version")
    # epoch() runs on the shards too: each shard applies its ops to its
    # own device buffers, then the probe runs on the updated blocks
    ep = ssess.epoch(inserts=([5], [1]), queries=[0], budget_walks=512)
    if not (ep.version == 2 and ep.results[0].version == 2):
        raise RuntimeError("the sharded epoch does not see its update")
    print(f"sharded epoch: {ep.updates_applied} update + "
          f"{len(ep.results)} query ({ep.results[0].variant})")

    # --- serving over HTTP: the network front end (DESIGN.md §8) ----------
    # SimRankService cuts concurrent clients' queries into micro-batches
    # (one fused dispatch per cut), bounds admission (429 + Retry-After),
    # and routes X-Tenant headers to per-tenant sessions over ONE shared
    # graph.  start_server binds a stdlib ThreadingHTTPServer over it.
    from repro_torch.serving import (
        ServiceClient,
        ServiceConfig,
        SimRankService,
        start_server,
        stop_server,
    )

    svc = SimRankService(handle, config=ServiceConfig(
        batch_window_ms=5.0, default_budget_walks=256))
    server, thread = start_server(svc)  # port=0 picks a free port
    host, port = server.server_address
    try:
        with ServiceClient(host, port, tenant="quickstart") as client:
            reply = client.query(node=0, kind="topk", k=3, seed=7)
            print(f"HTTP top-3 for 'a' (tenant={reply['tenant']}, "
                  f"batch_size={reply['batch_size']}):",
                  _named(reply["topk_nodes"], reply["topk_scores"]))
            rep = client.update(inserts=[(5, 0)])  # serialized; bumps version
            if client.healthz()["version"] != rep["version"]:
                raise RuntimeError("healthz does not report the new version")
    finally:
        stop_server(server, thread)  # drains in-flight requests, then closes


if __name__ == "__main__":
    main()
