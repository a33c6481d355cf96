"""Typed request/response envelopes for the session API.

A copy of ``repro.api.spec`` (plain Python; ``key`` is an int seed in the
port — torch has no typed keys).  ``tests/test_torch_session.py`` pins the
two equal field for field.

``QuerySpec`` is the one request type for every SimRank query the system
serves — single-source score vectors and top-k lists, one node or a fused
batch, full-accuracy or anytime-budgeted — and ``ResultEnvelope`` the one
response type, carrying the scores *and* the metadata a serving system
needs to trust them: the graph ``version`` the query ran against, the walk
budget actually spent, and the Theorem-1/2 absolute-error bound evaluated
at that *effective* budget (an anytime query reports the error it actually
guarantees, not the one the full budget would have).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

VARIANTS = ("auto", "telescoped", "tree", "reference", "randomized")
KINDS = ("single_source", "topk")


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One SimRank query request.

    Exactly one of ``node`` (single query) or ``nodes`` (fused batch) must
    be set.  ``k`` is only meaningful for ``kind='topk'`` (None = the
    session default).  ``budget_walks`` caps the walk pool (anytime mode;
    None = the full Theorem-1 budget).  ``variant='auto'`` defers the
    deterministic-vs-batched probe choice (paper §4.4) to the session
    planner; explicit variants pin it.  ``key`` optionally fixes the
    random stream as an int seed — a scalar seed reproduces the
    ``single_source``/``topk``/``multi_source`` seed-split semantics
    exactly, a sequence of Q int seeds is passed through as per-query
    streams; None lets the session assign its own submit-order stream.

    ``epsilon`` requests *adaptive accuracy*: the session escalates the
    walk budget geometrically until the Thm-1/2 analytic bound or the
    empirical CLT certificate meets it (``core/accuracy.py``), with
    ``budget_walks`` (or the flat Thm-1 budget) as the cap — the envelope
    then reports the certified bound and which certificate fired.
    ``epsilon=0.0`` is valid and never certifiable: the controller runs
    the full schedule to the cap (how the parity tests pin escalated ==
    one-shot).  ``confidence`` sets the empirical certificate's coverage
    (None = the session default, 0.99).
    """

    kind: str = "topk"
    node: int | None = None
    nodes: tuple[int, ...] | None = None
    k: int | None = None
    budget_walks: int | None = None
    variant: str = "auto"
    key: Any = None
    epsilon: float | None = None
    confidence: float | None = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.variant not in VARIANTS:
            raise ValueError(
                f"variant must be one of {VARIANTS}, got {self.variant!r}"
            )
        if (self.node is None) == (self.nodes is None):
            raise ValueError("exactly one of node / nodes must be set")
        if self.node is not None:
            object.__setattr__(self, "node", int(self.node))
        if self.nodes is not None:
            object.__setattr__(
                self,
                "nodes",
                tuple(int(u) for u in np.asarray(self.nodes).reshape(-1)),
            )
        if self.k is not None and self.k < 1:
            raise ValueError("k must be >= 1")
        if self.budget_walks is not None and self.budget_walks < 1:
            raise ValueError("budget_walks must be >= 1")
        if self.epsilon is not None and self.epsilon < 0.0:
            raise ValueError("epsilon must be >= 0")
        if self.confidence is not None and not 0.0 < self.confidence < 1.0:
            raise ValueError("confidence must be in (0, 1)")
        if self.confidence is not None and self.epsilon is None:
            raise ValueError("confidence requires epsilon (adaptive mode)")

    @property
    def q(self) -> int:
        """Number of queries this spec fans out to."""
        return 1 if self.nodes is None else len(self.nodes)


def as_spec(x: "QuerySpec | int", *, default_k: int | None = None) -> QuerySpec:
    """Coerce a bare node id to a default top-k spec; fill the default k."""
    spec = x if isinstance(x, QuerySpec) else QuerySpec(kind="topk", node=int(x))
    if spec.kind == "topk" and spec.k is None and default_k is not None:
        spec = dataclasses.replace(spec, k=default_k)
    return spec


@dataclasses.dataclass
class ResultEnvelope:
    """One SimRank query response (host-side numpy; device work is done).

    For ``kind='single_source'``: ``scores`` is the estimate vector ([n],
    or [Q, n] for a batched spec).  For ``kind='topk'``: ``topk_nodes`` /
    ``topk_scores`` are [k] (or [Q, k]); the query node itself is excluded.
    ``version`` attributes the scores to a graph snapshot; ``error_bound``
    is the Thm 1+2 absolute-error bound at the *effective* ``walks_used``
    (see ``repro_torch.core.params.abs_error_bound``); ``variant`` records what
    the session planner actually dispatched.

    Adaptive queries (``spec.epsilon`` set) additionally report the
    accuracy-controller outcome: ``epsilon`` echoes the request,
    ``certified_bound`` is the tightest bound certified at the stopping
    point (min of the analytic and empirical certificates — may be below
    ``error_bound``, which stays the analytic bound at ``walks_used``),
    ``certificate`` names what fired (``analytic`` / ``empirical``) or why
    escalation stopped without meeting epsilon (``budget`` / ``deadline``),
    and ``rounds`` counts the escalation rounds executed.

    Field-superset of the legacy ``QueryResult`` — engine shims return
    envelopes directly.
    """

    kind: str = "topk"
    node: int | None = None
    nodes: tuple[int, ...] | None = None
    scores: np.ndarray | None = None
    topk_nodes: np.ndarray | None = None
    topk_scores: np.ndarray | None = None
    walks_used: int = 0
    latency_s: float = 0.0
    version: int = -1
    error_bound: float = float("nan")
    variant: str = "telescoped"
    epsilon: float | None = None
    certified_bound: float = float("nan")
    certificate: str | None = None
    rounds: int = 1
