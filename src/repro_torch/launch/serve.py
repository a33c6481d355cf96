"""Serving launcher — the paper's end-to-end driver (port of
``repro.launch.serve``).

Runs a ``SimRankSession`` against a synthetic power-law graph with a
dynamic update stream interleaved between query dispatches (the paper's §1
motivation: index-free => updates are free).  Reports per-query latency and
top-k results; optional straggler policy wraps dispatch.  The graph lives
on ``--device`` (default ``cuda``; ``--device cpu`` runs the kernels'
plain versions).

``--backend sharded --shards N`` serves the same stream through the
sharded backend (the graph cut into N destination row blocks on a
``ShardMesh``; N defaults to the number of visible CUDA devices).  With
``--device cuda`` the blocks go one per visible card (the count must be
divisible by N); a device with an index (``cuda:0``) or ``cpu`` holds all N
blocks.  Updates then apply shard-wise, with the same version and overflow
semantics.

``--epochs`` fuses each update burst WITH its query into one epoch
(``SimRankSession.epoch``: the burst is written into the mirrors in place,
then the query is served on them, with no host read in between).

``--epsilon`` serves every query through the adaptive accuracy controller
(``core/accuracy.py``): escalate walks geometrically until a certificate
meets the requested absolute error, capped at ``--walk-budget`` (or the
flat Thm-1 budget).  Combined with ``--deadline-s`` the deadline rides
in-band (``straggler.dispatch_adaptive``): a miss degrades to the
best-so-far certificate instead of a shed retry.

``--serve`` starts the network service instead of the driver loop: the
threaded HTTP front end (``serving/server.py``) over a
:class:`SimRankService` (micro-batching window, admission control,
per-tenant sessions) on ``--host``/``--port``.  The driver's graph flags
build the served graph; ``--batch-window-ms`` / ``--max-batch-q`` /
``--max-inflight`` tune the collector.  Ctrl-C shuts down gracefully
(drains in-flight requests).

Usage:
  python -m repro_torch.launch.serve --nodes 20000 --edges 200000 \\
      --queries 20 --updates-per-batch 100 --eps-a 0.1
  python -m repro_torch.launch.serve --queries 20 --epsilon 0.1 --deadline-s 2.0
  python -m repro_torch.launch.serve --epochs
  python -m repro_torch.launch.serve --backend sharded --shards 4 --epochs
  python -m repro_torch.launch.serve --serve --port 8311 --walk-budget 512
  python -m repro_torch.launch.serve --device cpu --nodes 300 --edges 2000
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import GraphHandle, QuerySpec, SimRankSession
from repro_torch.serving.straggler import (
    HedgePolicy,
    dispatch,
    dispatch_adaptive,
)


def _top3(res) -> str:
    return ", ".join(
        f"{nn}:{s:.4f}" for nn, s in zip(res.topk_nodes[:3], res.topk_scores[:3])
    )


def main(argv=None) -> list | None:
    """Run the driver loop and return the served envelopes, or, with
    ``--serve``, run the HTTP service until interrupted."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--edges", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--updates-per-batch", type=int, default=64)
    ap.add_argument("--eps-a", type=float, default=0.1)
    ap.add_argument("--c", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--walk-budget", type=int, default=None,
                    help="cap walks per query (anytime mode; with "
                         "--epsilon: the escalation cap)")
    ap.add_argument("--epsilon", type=float, default=None,
                    help="adaptive accuracy: escalate walks per query "
                         "until this absolute-error target is certified")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the graph lives and the queries run")
    ap.add_argument("--backend", choices=("local", "sharded"), default="local")
    ap.add_argument("--shards", type=int, default=None,
                    help="row-partition count for --backend sharded "
                         "(default: the CUDA device count)")
    ap.add_argument("--epochs", action="store_true",
                    help="serve each update burst + query as ONE fused "
                         "epoch instead of update() + query()")
    ap.add_argument("--serve", action="store_true",
                    help="start the HTTP serving front end instead of the "
                         "driver loop (POST /query, POST /update, "
                         "GET /stats, GET /healthz)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8311)
    ap.add_argument("--batch-window-ms", type=float, default=10.0,
                    help="--serve: micro-batch collector window")
    ap.add_argument("--max-batch-q", type=int, default=16,
                    help="--serve: fused-dispatch lane count (batch cut "
                         "fires early when this many queries wait)")
    ap.add_argument("--max-inflight", type=int, default=256,
                    help="--serve: admission bound; past it clients get "
                         "429 + Retry-After")
    args = ap.parse_args(argv)
    if args.epsilon is not None and args.epochs:
        ap.error("--epsilon and --epochs are mutually exclusive: --epsilon "
                 "queries are served by the host-side escalation loop and "
                 "cannot ride inside a fused --epochs dispatch — drop one "
                 "of the two flags")

    from repro_torch.graph import powerlaw_graph

    rng = np.random.default_rng(args.seed)
    src, dst, n = powerlaw_graph(args.nodes, args.edges, seed=args.seed)
    in_deg = np.bincount(dst, minlength=n)
    handle = GraphHandle.from_edges(
        src, dst, n,
        capacity=len(src) + 100_000,
        k_max=int(in_deg.max()) + 8,
        device=args.device,
    )

    mesh = _mesh(args) if args.backend == "sharded" else None

    if args.serve:
        _serve_forever(handle, args, mesh, n=n, m=len(src))
        return None

    sess = SimRankSession(
        handle, c=args.c, eps_a=args.eps_a, top_k=args.top_k, seed=args.seed,
        backend=args.backend, mesh=mesh,
        batch_q=1, update_batch=args.updates_per_batch,
    )
    # the batch dispatch label names the step a Q-query burst lands on
    # (e.g. "sharded[spmd,Q=1]"): backend + probe + query count
    print(f"graph: n={n} m={len(src)} on {handle.device}; "
          f"n_r={sess.params.n_r} walks/query (eps_a={args.eps_a}), "
          f"max_len={sess.params.max_len}; "
          f"dispatch={sess.backend.batch_dispatch_label(sess.batch_q)}"
          + (f" mesh={mesh}" if mesh is not None else "")
          + (" [fused epochs]" if args.epochs else ""))

    query_nodes = rng.choice(np.where(in_deg > 0)[0], size=args.queries)
    lat, served = [], []
    for i, u in enumerate(query_nodes):
        # interleave a dynamic update batch — no index rebuild
        ins_src = rng.integers(0, n, args.updates_per_batch).astype(np.int32)
        ins_dst = rng.integers(0, n, args.updates_per_batch).astype(np.int32)

        if args.epochs:
            # ONE epoch: apply the burst + serve the query on the
            # post-update snapshot
            ep = sess.epoch(
                inserts=(ins_src, ins_dst),
                queries=[QuerySpec(kind="topk", node=int(u),
                                   budget_walks=args.walk_budget)],
            )
            res = ep.results[0]
            served.append(res)
            lat.append(ep.latency_s)
            print(f"q{i} u={u}: epoch({ep.updates_applied} edges + query)"
                  f"={ep.latency_s:.2f}s v{res.version} top3=[{_top3(res)}]")
            continue

        t0 = time.time()
        upd = sess.update(inserts=(ins_src, ins_dst))
        upd_t = time.time() - t0

        if args.epsilon is not None:
            spec = QuerySpec(kind="topk", node=int(u), epsilon=args.epsilon,
                             budget_walks=args.walk_budget)
            if args.deadline_s:
                # deadline rides in-band: a miss freezes best-so-far
                # (certificate='deadline') instead of shedding + retrying
                res = dispatch_adaptive(
                    sess.query, spec,
                    policy=HedgePolicy(deadline_s=args.deadline_s),
                )
            else:
                res = sess.query(spec)
            served.append(res)
            lat.append(res.latency_s)
            print(f"q{i} u={u}: update({upd.applied} edges)={upd_t*1e3:.1f}ms "
                  f"query={res.latency_s:.2f}s v{res.version} "
                  f"walks={res.walks_used}/{sess.params.n_r} "
                  f"cert={res.certificate}@{res.certified_bound:.4f} "
                  f"rounds={res.rounds} top3=[{_top3(res)}]")
            continue

        if args.deadline_s:
            def on_retry(attempt):
                # report through the public stats API — EngineStats is
                # owned by the session/backend; external dispatch wrappers
                # must not mutate its fields directly
                sess.record_retry()
                print(f"  retry {attempt} (shed budget)")

            # dispatch injects budget_walks per attempt (shed on retries);
            # an abandoned attempt holds the session lock until it ends, so
            # the retry never runs beside it
            res = dispatch(
                sess.query, QuerySpec(kind="topk", node=int(u)),
                policy=HedgePolicy(deadline_s=args.deadline_s),
                budget=args.walk_budget or sess.params.n_r,
                on_retry=on_retry,
            )
        else:
            res = sess.query(QuerySpec(kind="topk", node=int(u),
                                       budget_walks=args.walk_budget))
        served.append(res)
        lat.append(res.latency_s)
        print(f"q{i} u={u}: update({upd.applied} edges)={upd_t*1e3:.1f}ms "
              f"query={res.latency_s:.2f}s v{res.version} top3=[{_top3(res)}]")
    lat = np.array(lat)
    print(f"latency: mean={lat.mean():.2f}s p50={np.percentile(lat,50):.2f}s "
          f"p99={np.percentile(lat,99):.2f}s; "
          f"updates applied: {sess.stats.updates}; "
          f"dispatches: {sess.stats.steps}; retries: {sess.stats.retries}"
          + (f"; escalations: {sess.stats.escalations}; "
             f"hub hits: {sess.stats.hub_hits}"
             if args.epsilon is not None else ""))
    return served


def _mesh(args):
    """The ``ShardMesh`` of ``--backend sharded``: one block per visible
    card for ``--device cuda``, else every block on ``--device``."""
    from repro_torch.launch.mesh import mesh_for

    return mesh_for(args.device, args.shards)


def _serve_forever(handle, args, mesh, *, n: int, m: int) -> None:
    """--serve mode: run the HTTP service until interrupted."""
    from repro_torch.serving import (
        ServiceConfig,
        SimRankService,
        start_server,
        stop_server,
    )

    svc = SimRankService(
        handle,
        backend=args.backend,
        mesh=mesh,
        config=ServiceConfig(
            batch_window_ms=args.batch_window_ms,
            max_batch_q=args.max_batch_q,
            max_inflight=args.max_inflight,
            default_budget_walks=args.walk_budget,
        ),
        seed=args.seed,
        session_kwargs=dict(c=args.c, eps_a=args.eps_a, top_k=args.top_k),
    )
    server, thread = start_server(svc, args.host, args.port)
    host, port = server.server_address
    print(f"serving n={n} m={m} on http://{host}:{port} "
          f"(backend={args.backend}"
          + (f" mesh={mesh}" if mesh is not None else f" device={handle.device}")
          + f", window={args.batch_window_ms}ms, "
          f"batch_q={args.max_batch_q}, max_inflight={args.max_inflight}); "
          "POST /query /update, GET /stats /healthz; Ctrl-C to stop",
          flush=True)
    try:
        # polling join: a bare join() parks in an uninterruptible C-level
        # acquire on some platforms; this stays responsive to Ctrl-C
        while thread.is_alive():
            thread.join(timeout=0.5)
    except KeyboardInterrupt:
        print("\nshutting down (draining in-flight requests)...", flush=True)
        stop_server(server, thread)


if __name__ == "__main__":
    main()
