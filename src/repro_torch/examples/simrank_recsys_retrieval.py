"""ProbeSim as the retrieval stage of the Wide & Deep ranker, over a live
interaction stream (port of ``examples/simrank_recsys_retrieval.py``).

SimRank on the user->item bipartite interaction graph is a classic
collaborative-filtering similarity.  ProbeSim computes it index-free, so
the recommender can run on a sliding window of recent interactions:
timestamped click events stream in, old interactions age out of the TTL
window as delete batches, and every retrieval query is exact with respect
to the current window, with no index rebuild between an interaction and
the next recommendation.  Wide & Deep then re-ranks the retrieved
candidates.

The stages are functions (``interaction_stream``, ``serve_stream`` =
``open_session`` + ``stream_into``, ``retrieve`` = ``retrieval_query`` +
``item_candidates``, ``rerank_batch``) so a caller can run them at another
size or check each one; ``main`` runs the reference's toy size.  Seeds
are the port's ints where the reference passes ``jax.random.key``s, so the
answers are the port's own draws.

Run:  PYTHONPATH=src python -m repro_torch.examples.simrank_recsys_retrieval
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import GraphHandle, QuerySpec, SimRankSession
from repro_torch.configs.base import RecsysConfig
from repro_torch.graph import bipartite_graph
from repro_torch.models.recsys.widedeep import init_widedeep, widedeep_forward
from repro_torch.streams import (
    EventStream,
    FreshnessSLO,
    SessionTransport,
    StreamDriver,
)

# the reference's stream settings
TICK_S = 0.1
QUERIES_PER_TICK = 2
UPDATE_BURST = 256
TTL_SHARE = 0.4  # the TTL window, a share of the stream's horizon


def interaction_stream(n_users: int, n_items: int, m: int, horizon: float, *,
                       seed: int = 0, alpha: float = 1.8) -> tuple[EventStream, int]:
    """Timestamped click events (bipartite arrivals).

    ``bipartite_graph`` emits each interaction as an edge pair (u->i, then
    i->u, in concatenated halves); one click timestamp covers both
    directions, so the sliding window stays symmetric as interactions age
    out."""
    src, dst, n = bipartite_graph(n_users, n_items, m, seed=seed, alpha=alpha)
    half = len(src) // 2
    rng = np.random.default_rng(seed + 1)
    t = np.tile(np.sort(rng.uniform(0.0, horizon, size=half)), 2)
    order = np.argsort(t, kind="stable")  # pair-interleaved, u->i first
    return EventStream(t[order], src[order], dst[order], n), n


def open_session(n: int, *, capacity: int, k_max: int, device) -> SimRankSession:
    """A session over an empty graph of ``n`` nodes with the example's
    settings.  ``k_max`` must hold the largest in-degree the window reaches
    (an item-popularity hub)."""
    e = np.empty(0, np.int32)
    handle = GraphHandle.from_edges(e, e, n, capacity=capacity, k_max=k_max,
                                    device=device)
    return SimRankSession(handle, c=0.6, eps_a=0.1, delta=0.05, top_k=50, seed=0)


def stream_into(sess: SimRankSession, stream: EventStream, *, ttl: float,
                max_ticks: int | None = None):
    """Serve ``stream`` through ``sess``: arrivals and TTL expiry in bursts
    of UPDATE_BURST through fused session epochs
    (``SessionTransport(mode="epoch")``), QUERIES_PER_TICK retrieval
    queries a tick from the live window, a pooled checkpoint every 10
    ticks; ``max_ticks`` streams only the leading ticks.  Returns the
    ``StreamReport``."""
    driver = StreamDriver(
        SessionTransport(sess, mode="epoch"), stream,
        ttl=ttl, tick_s=TICK_S, queries_per_tick=QUERIES_PER_TICK,
        update_burst=UPDATE_BURST, k=20, budget_walks=512,
        slo=FreshnessSLO(staleness_p99_s=2.0),
        checkpoint_every=10, checkpoint_queries=2,
        expert_r=1_000, fresh_budget=2_000,
    )
    return driver.run(max_ticks=max_ticks)


def serve_stream(stream: EventStream, *, ttl: float, capacity: int, k_max: int,
                 device, max_ticks: int | None = None):
    """``stream_into`` a new ``open_session``: returns
    ``(session, StreamReport)``."""
    sess = open_session(stream.n, capacity=capacity, k_max=k_max, device=device)
    return sess, stream_into(sess, stream, ttl=ttl, max_ticks=max_ticks)


def retrieval_query(sess: SimRankSession, n_users: int, *, k: int = 50) -> QuerySpec:
    """The top-k query from the hottest item of the live window (exact with
    respect to the window, no index rebuild), under a pinned key."""
    in_deg = sess.handle.eg.in_deg.cpu().numpy()
    seed_item = n_users + int(np.argmax(in_deg[n_users:]))
    return QuerySpec(kind="topk", node=seed_item, k=k, budget_walks=2_000, key=0)


def item_candidates(env, n_users: int, n_cands: int = 20):
    """The items of a top-k envelope, best first: ``(candidate items
    [<= n_cands], their SimRank scores)``, item ids counted from 0."""
    nodes, scores = np.asarray(env.topk_nodes), np.asarray(env.topk_scores)
    items = nodes >= n_users
    return nodes[items][:n_cands] - n_users, scores[items][:n_cands]


def retrieve(sess: SimRankSession, n_users: int, *, k: int = 50, n_cands: int = 20):
    """``retrieval_query`` answered by ``sess``: returns ``(seed item,
    candidate items, their SimRank scores)``, item ids counted from 0."""
    spec = retrieval_query(sess, n_users, k=k)
    return (spec.node - n_users, *item_candidates(sess.query(spec), n_users, n_cands))


def rerank_batch(cands: np.ndarray, cfg, rng: np.random.Generator, device) -> dict:
    """One user's ranking batch over ``cands``: field 0 the candidate item,
    every other field a random id below 100, dense features N(0, 1)."""
    B = len(cands)
    fields = [cands] + [rng.integers(0, 100, B) for _ in range(cfg.n_sparse - 1)]
    return dict(
        sparse_ids=torch.from_numpy(np.stack(fields, axis=1).astype(np.int32)).to(device),
        dense=torch.from_numpy(rng.normal(size=(B, cfg.n_dense)).astype(np.float32)).to(device),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n_users, n_items = 1_000, 300
    horizon = 2.0  # seconds of virtual time
    stream, n = interaction_stream(n_users, n_items, 12_000, horizon)

    # k_max is sized for the item-popularity hubs a bipartite click graph
    # grows (auto-regrow would recover from a miss, at a rebuild's cost)
    sess, rep = serve_stream(stream, ttl=TTL_SHARE * horizon, capacity=1 << 13,
                             k_max=512, device=args.device)
    print(
        f"streamed {rep.arrivals} interactions, expired {rep.expired} "
        f"(window={rep.final_live_edges}); {rep.queries} retrievals at "
        f"{rep.qps:.1f} qps, staleness p99 {rep.staleness_p99_s * 1e3:.0f}ms "
        f"(SLO met: {rep.slo_met})"
    )
    for cp in rep.checkpoints:
        print(f"  churn checkpoint t={cp.t:.1f}s: pooled p@20="
              f"{cp.precision_at_k:.2f} over {cp.live_edges} live edges")

    seed_item, cands, scores = retrieve(sess, n_users)
    print(f"seed item {seed_item}: retrieved {len(cands)} candidate items from the "
          f"live window, top5={[int(i) for i in cands[:5]]} "
          f"simrank={[round(float(s), 4) for s in scores[:5]]}")
    if len(cands) == 0:
        print("no item candidates in the live window; skipping re-rank")
        return

    # ranking: Wide & Deep scores the retrieved candidates for one user
    cfg = RecsysConfig(name="wd", n_sparse=6, embed_dim=16, mlp=(64, 32),
                       vocab_per_field=max(n_items, 1000), n_dense=4)
    gen = torch.Generator(device=sess.handle.device)
    gen.manual_seed(1)
    wd = init_widedeep(gen, cfg)
    batch = rerank_batch(cands, cfg, rng, sess.handle.device)
    with torch.no_grad():
        ctr = torch.sigmoid(widedeep_forward(wd, batch, cfg)).cpu().numpy()
    order = np.argsort(-ctr)
    print("wide-deep re-ranked top5:",
          [(int(cands[i]), round(float(ctr[i]), 3)) for i in order[:5]])


if __name__ == "__main__":
    main()
