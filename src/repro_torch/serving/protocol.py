"""Wire schemas for the HTTP serving front end (``serving/server.py``), a
copy of ``repro.serving.protocol`` (``tests/test_torch_service.py`` pins the
two equal: same dataclasses, same ``ProtocolError`` messages, same JSON).

One place owns the JSON contract: what a client may POST, what the
service responds, and what a malformed request looks like.  Everything
here is stdlib + numpy — no torch, no HTTP — so the schemas are importable
from clients, benchmarks and tests without touching the serving stack.

Request schema (``POST /query``)::

    {"kind": "topk" | "single_source",   # default "topk"
     "node": <int>,                       # required: the query node
     "k": <int>,                          # topk width (default: server's)
     "budget_walks": <int>,               # walk cap (anytime mode)
     "epsilon": <float>,                  # adaptive accuracy target
     "confidence": <float>,               # empirical-certificate coverage
     "deadline_s": <float>,               # relative deadline from arrival
     "seed": <int>}                       # pin the PRNG stream (parity /
                                          # reproducibility; else the
                                          # tenant session assigns one)

Batches are NOT part of the wire schema on purpose: cross-connection
micro-batching is the server's job (``serving/service.py`` cuts windows
across concurrent clients), so a client wanting Q answers opens Q
requests and lets the collector fuse them.

Update schema (``POST /update``)::

    {"inserts": [[src, dst], ...], "deletes": [[src, dst], ...]}

Responses are :func:`envelope_to_wire` dicts (the ``ResultEnvelope``
fields plus service-side metadata: queue delay, the micro-batch size the
query rode in, the tenant).  Errors are ``{"error": <message>}`` with the
HTTP status carrying the class (400 malformed, 404 route, 413 too large,
429 admission, 503 shutdown, 504 deadline shed).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

KINDS = ("single_source", "topk")

# bounds a hostile/buggy request body before numpy sees it
MAX_UPDATE_OPS = 1_000_000


class ProtocolError(ValueError):
    """Malformed wire request — maps to HTTP 400."""


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """Validated ``POST /query`` body (see module docstring for the JSON)."""

    kind: str = "topk"
    node: int = 0
    k: int | None = None
    budget_walks: int | None = None
    epsilon: float | None = None
    confidence: float | None = None
    deadline_s: float | None = None
    seed: int | None = None


def _require_int(obj: dict, name: str, *, minimum: int | None = None):
    v = obj[name]
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ProtocolError(f"{name!r} must be an integer, got {v!r}")
    if minimum is not None and v < minimum:
        raise ProtocolError(f"{name!r} must be >= {minimum}, got {v}")
    return int(v)


def _require_float(obj: dict, name: str, *, minimum: float | None = None):
    v = obj[name]
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ProtocolError(f"{name!r} must be a number, got {v!r}")
    v = float(v)
    if not math.isfinite(v):
        raise ProtocolError(f"{name!r} must be finite, got {v!r}")
    if minimum is not None and v < minimum:
        raise ProtocolError(f"{name!r} must be >= {minimum}, got {v}")
    return v


_QUERY_FIELDS = frozenset(
    f.name for f in dataclasses.fields(QueryRequest)
)


def parse_query_request(obj) -> QueryRequest:
    """Validate a decoded ``POST /query`` body into a :class:`QueryRequest`.

    Unknown fields are rejected (a typo'd ``"budget_walk"`` silently
    serving the full Thm-1 budget is the failure mode this guards).
    """
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"query body must be a JSON object, got {type(obj).__name__}"
        )
    unknown = sorted(set(obj) - _QUERY_FIELDS)
    if unknown:
        raise ProtocolError(
            f"unknown query field(s) {unknown} "
            f"(schema: {sorted(_QUERY_FIELDS)})"
        )
    kind = obj.get("kind", "topk")
    if kind not in KINDS:
        raise ProtocolError(f"kind must be one of {KINDS}, got {kind!r}")
    if "node" not in obj:
        raise ProtocolError("query requires a 'node' field")
    node = _require_int(obj, "node", minimum=0)
    if node is None:
        raise ProtocolError("'node' must not be null")
    merged = {**{f: None for f in _QUERY_FIELDS}, **obj}
    epsilon = _require_float(merged, "epsilon", minimum=0.0)
    confidence = _require_float(merged, "confidence")
    if confidence is not None and not 0.0 < confidence < 1.0:
        raise ProtocolError(f"confidence must be in (0, 1), got {confidence}")
    if confidence is not None and epsilon is None:
        raise ProtocolError("confidence requires epsilon (adaptive mode)")
    deadline_s = _require_float(merged, "deadline_s")
    if deadline_s is not None and deadline_s < 0.0:
        raise ProtocolError(f"deadline_s must be >= 0, got {deadline_s}")
    return QueryRequest(
        kind=kind,
        node=node,
        k=_require_int(merged, "k", minimum=1),
        budget_walks=_require_int(merged, "budget_walks", minimum=1),
        epsilon=epsilon,
        confidence=confidence,
        deadline_s=deadline_s,
        seed=_require_int(merged, "seed"),
    )


def _parse_ops(obj: dict, name: str) -> np.ndarray | None:
    ops = obj.get(name)
    if ops is None:
        return None
    if not isinstance(ops, list):
        raise ProtocolError(f"{name!r} must be a list of [src, dst] pairs")
    if len(ops) > MAX_UPDATE_OPS:
        raise ProtocolError(
            f"{name!r} carries {len(ops)} ops (limit {MAX_UPDATE_OPS}); "
            "split the batch"
        )
    out = np.empty((len(ops), 2), np.int64)
    for i, pair in enumerate(ops):
        if (
            not isinstance(pair, (list, tuple))
            or len(pair) != 2
            or any(isinstance(x, bool) or not isinstance(x, int) for x in pair)
        ):
            raise ProtocolError(
                f"{name}[{i}] must be an integer [src, dst] pair, "
                f"got {pair!r}"
            )
        out[i] = pair
    if out.size and out.min() < 0:
        raise ProtocolError(f"{name!r} contains a negative node id")
    return out


def parse_update_request(obj) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Validate a ``POST /update`` body into (inserts, deletes) op arrays.

    Each is an ``[B, 2]`` int array of (src, dst) pairs, or ``None`` when
    the field is absent.  At least one must be present and non-empty.
    """
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"update body must be a JSON object, got {type(obj).__name__}"
        )
    unknown = sorted(set(obj) - {"inserts", "deletes"})
    if unknown:
        raise ProtocolError(
            f"unknown update field(s) {unknown} "
            "(schema: ['deletes', 'inserts'])"
        )
    inserts = _parse_ops(obj, "inserts")
    deletes = _parse_ops(obj, "deletes")
    if (inserts is None or not len(inserts)) and (
        deletes is None or not len(deletes)
    ):
        raise ProtocolError("update carries no ops (inserts/deletes empty)")
    return inserts, deletes


def _jsonable(x):
    """Host-side scalars/arrays -> JSON-clean values (NaN -> None)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, float)):
        x = float(x)
        return x if math.isfinite(x) else None
    if isinstance(x, (np.integer, int)):
        return int(x)
    return x


def envelope_to_wire(env, **extra) -> dict:
    """``ResultEnvelope`` -> response dict (module docstring schema).

    ``extra`` carries the service-side fields (``tenant``,
    ``queue_delay_s``, ``batch_size``).  Score arrays are emitted as JSON
    lists; float32 values survive the round trip exactly (JSON ``repr``
    of the exact float64 widening), so clients can reproduce bitwise
    parity against a local session under matched streams.
    """
    out = dict(
        kind=env.kind,
        node=_jsonable(env.node),
        walks_used=_jsonable(env.walks_used),
        latency_s=_jsonable(env.latency_s),
        version=_jsonable(env.version),
        error_bound=_jsonable(env.error_bound),
        variant=env.variant,
    )
    if env.scores is not None:
        out["scores"] = _jsonable(np.asarray(env.scores))
    if env.topk_nodes is not None:
        out["topk_nodes"] = _jsonable(np.asarray(env.topk_nodes))
        out["topk_scores"] = _jsonable(np.asarray(env.topk_scores))
    if env.epsilon is not None:
        out["epsilon"] = _jsonable(env.epsilon)
        out["certified_bound"] = _jsonable(env.certified_bound)
        out["certificate"] = env.certificate
        out["rounds"] = _jsonable(env.rounds)
    out.update({k: _jsonable(v) for k, v in extra.items()})
    return out


def update_report_to_wire(rep, **extra) -> dict:
    """``UpdateReport`` -> ``POST /update`` response dict."""
    out = dict(
        submitted=int(rep.submitted),
        applied=int(rep.applied),
        regrows=int(rep.regrows),
        skipped=len(rep.skipped),
        version=int(rep.version),
        overflow=bool(rep.overflow),
    )
    out.update({k: _jsonable(v) for k, v in extra.items()})
    return out
