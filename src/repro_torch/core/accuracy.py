"""Adaptive accuracy controller — spend walks only where the bound needs them.

A copy of ``repro.core.accuracy`` on the port's ``core/params.py`` (numpy;
pinned equal by ``tests/test_torch_accuracy.py``).  The controller works
on host ``[Q, n]`` score rows and stays on the host.

ProbeSim's headline guarantee (Thm 1/2) is an *absolute-error bound*, but a
flat walk budget buys the same n_r for every query regardless of how many
walks that query actually needs: ``error_bound_at_budget`` sits at ~0.28
for 512 walks while typical measured errors are 10-50x smaller, because the
analytic bound assumes worst-case per-walk variance (3c) and a union over
all n nodes.  The controller closes that gap per query:

* serve at a small initial budget, then **escalate geometrically** — round
  ``r`` draws its walks from seed ``derive_seed(stream_seed, r)`` on top of
  the carried accumulator, so the cumulative estimate after rounds 0..r is
  the exact weighted mean over all walks drawn so far (and an escalated
  run is bitwise identical to a one-shot run whose budget cap equals the
  same cumulative point: both execute the same round schedule under the
  same per-round seeds);
* after every round, try to **certify** the requested epsilon with the
  cheapest certificate that fires:

  - ``analytic`` — the Thm-1/2 bound
    :func:`~repro_torch.core.params.abs_error_bound` evaluated at the
    cumulative walk count (data-independent: known in advance via
    :func:`~repro_torch.core.params.walks_for_error`);
  - ``empirical`` — a CLT confidence interval built from the *measured*
    between-round score variance (an unbiased estimate of the per-walk
    variance), union-bounded over nodes.  Real per-walk variance is far
    below the worst case, so this typically fires with 5-20x fewer walks
    than the analytic budget — the whole point of escalating;
  - ``budget`` — the schedule cap was reached without meeting epsilon:
    the query degrades to an anytime answer that honestly reports the
    bound it achieved;
  - ``deadline`` — escalation was clamped by a serving deadline: best-so-far
    scores + the achieved bound, never an exception on the query path.

The schedule cap never exceeds the flat Thm-1 budget for the same epsilon,
so the controller *structurally* cannot spend more walks than flat serving
(``walks_saved_ratio >= 1`` is an invariant, not a measurement).

Hub sharing (PRSim's power-law analysis, arxiv 1905.02354): on skewed
graphs a few high in-degree hubs absorb a large fraction of query traffic.
:class:`ProbeCache` memoizes per-round probe score rows keyed on
``(node, graph version, round, round size, lane geometry)``; the session
routes hub queries (in-degree above a percentile) onto *node-keyed* seed
streams, which makes their per-round rows identical across queries and
drain batches — repeated hub probes then skip whole serve dispatches.
A graph-version bump invalidates the cache (the key carries the version
and the cache clears itself on a new one).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.params import (
    ProbeSimParams,
    abs_error_bound,
    bound_from_sampling_error,
)

__all__ = [
    "AccuracyController",
    "Certificate",
    "ProbeCache",
    "empirical_error_bound",
    "escalation_schedule",
    "normal_quantile",
]

# Per-walk deposits are probabilities (telescoped probe pushes mass <= 1
# per walk per node), so the per-walk score variance cannot exceed the
# [0, 1]-range worst case of 1/4.  Clamping the estimate there keeps the
# empirical CI provably no looser than necessary when the between-round
# scatter is noisy at small round counts.
_VAR_CLAMP = 0.25


def escalation_schedule(initial: int, cap: int) -> list[int]:
    """Per-round walk counts whose cumulative sums double up to ``cap``.

    ``[b, b, 2b, 4b, ...]`` — cumulative ``b, 2b, 4b, 8b, ...`` with the
    final round clipped so the total equals ``cap`` exactly.  The schedule
    is a pure function of ``(initial, cap)``: an escalated run that stops
    at cumulative N executes the same rounds as a one-shot run with
    ``cap=N`` — the property the bitwise parity tests pin.
    """
    initial = int(initial)
    cap = int(cap)
    if initial < 1:
        raise ValueError(f"initial budget must be >= 1, got {initial}")
    if cap < 1:
        raise ValueError(f"budget cap must be >= 1, got {cap}")
    if cap <= initial:
        return [cap]
    sizes = [initial]
    cum = initial
    while cum < cap:
        nxt = min(cum * 2, cap)
        sizes.append(nxt - cum)
        cum = nxt
    return sizes


def normal_quantile(p: float) -> float:
    """Inverse standard-normal CDF via bisection on ``math.erf``.

    Dependency-free (no scipy in the container); monotone bisection to
    1e-12, plenty for confidence levels down to 1 - 1e-12.
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile probability must be in (0, 1), got {p}")
    if p < 0.5:
        return -normal_quantile(1.0 - p)
    lo, hi = 0.0, 40.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def empirical_error_bound(
    params: ProbeSimParams,
    *,
    n: int,
    round_sizes,
    round_scores,
    confidence: float,
) -> float:
    """CLT certificate: total abs-error bound from measured round variance.

    ``round_scores`` is ``[R, n]`` — one score vector per escalation round
    (each the mean of that round's walks).  For i.i.d. walks split into
    rounds of sizes ``n_i``, ``sum_i n_i (s_i - s_mean)^2 / (R - 1)`` is an
    (approximately) unbiased estimate of the per-walk variance; the
    sampling CI half-width at ``confidence`` — two-sided, union-bounded
    over the ``n`` nodes like the analytic Thm-1 bound — is
    ``z * sigma_hat_max / sqrt(N)``.  The pruning and truncation shares
    stack on top exactly as in Thm 2
    (:func:`~repro_torch.core.params.bound_from_sampling_error`), so the
    empirical and analytic certificates differ only in the sampling term;
    with the variance estimate clamped at the [0, 1]-range worst case 1/4,
    the empirical sampling term is never above ``~0.5 z / sqrt(N)`` while
    the analytic one pays ``sqrt(3 c ln(n / delta)) / sqrt(N)`` — the
    empirical certificate is conservative in coverage yet strictly inside
    the analytic bound (the property tests pin both).

    Requires ``R >= 2`` (one round has no variance information): raises
    ValueError otherwise — callers gate on round count.
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    sizes = np.asarray(round_sizes, np.float64)
    scores = np.asarray(round_scores, np.float64)
    r = sizes.shape[0]
    if r < 2:
        raise ValueError(f"empirical CI needs >= 2 rounds, got {r}")
    if scores.shape[0] != r:
        raise ValueError(
            f"{r} round sizes vs {scores.shape[0]} round score vectors"
        )
    total = sizes.sum()
    mean = (sizes[:, None] * scores).sum(axis=0) / total
    var_walk = (sizes[:, None] * (scores - mean[None, :]) ** 2).sum(
        axis=0
    ) / (r - 1)
    sigma_max = math.sqrt(min(float(var_walk.max()), _VAR_CLAMP))
    alpha = (1.0 - confidence) / max(int(n), 1)  # union over nodes
    z = normal_quantile(1.0 - alpha / 2.0)  # two-sided
    h = z * sigma_max / math.sqrt(total)
    return bound_from_sampling_error(params, h)


@dataclasses.dataclass(frozen=True)
class Certificate:
    """What the controller certified for one query when it stopped.

    ``name`` is which certificate fired (``analytic`` / ``empirical``) or
    why escalation stopped without one (``budget`` / ``deadline``);
    ``bound`` the certified absolute-error bound (the min of both
    certificates at the stopping point — for budget/deadline stops this is
    the best achieved bound, honestly above the requested epsilon);
    ``walks`` the cumulative walks spent, ``rounds`` the rounds executed.
    """

    name: str
    bound: float
    walks: int
    rounds: int


class AccuracyController:
    """Carried-accumulator escalation state for one (batched) query group.

    The session drives it round by round — ``next_round()`` names the
    round to serve, the caller dispatches that round's walks through the
    backend (the fused lane-batched step, reused per round unchanged)
    and feeds the resulting ``[Q, n]`` score matrix to :meth:`absorb`.
    The controller carries the walk-weighted score sum, evaluates both
    certificates per query, and *freezes* a query the round its requested
    epsilon is met: frozen scores/certificates never change in later
    rounds (so a query's answer is independent of how long its batch mates
    keep escalating — the batch-invariance the seed contract promises).
    ``finish()`` freezes whatever is still live (budget cap exhausted or
    deadline shed) with the best achieved bound.
    """

    def __init__(
        self,
        params: ProbeSimParams,
        *,
        n: int,
        q: int,
        epsilon: float,
        confidence: float,
        plan: list[int],
        min_empirical_rounds: int = 2,
    ):
        if epsilon < 0.0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        if not plan:
            raise ValueError("empty escalation plan")
        self.params = params
        self.n = int(n)
        self.q = int(q)
        self.epsilon = float(epsilon)
        self.confidence = float(confidence)
        self.plan = [int(s) for s in plan]
        self.min_empirical_rounds = int(min_empirical_rounds)
        self.round_sizes: list[int] = []
        self._history: list[np.ndarray] = []  # per-round [q, n] float32
        self._carry = np.zeros((q, n), np.float64)  # walk-weighted score sum
        self.walks = 0
        self.certificates: list[Certificate | None] = [None] * q
        self._scores: list[np.ndarray | None] = [None] * q

    # -- round scheduling ----------------------------------------------------

    @property
    def rounds_done(self) -> int:
        return len(self.round_sizes)

    @property
    def all_frozen(self) -> bool:
        return all(c is not None for c in self.certificates)

    def next_round(self) -> int | None:
        """Walk count of the next scheduled round (None = plan exhausted)."""
        r = self.rounds_done
        return self.plan[r] if r < len(self.plan) else None

    # -- escalation ----------------------------------------------------------

    def _bounds(self, i: int) -> tuple[float, float]:
        """(analytic, empirical) total bounds for query ``i`` right now."""
        analytic = abs_error_bound(self.params, n=self.n, n_r=self.walks)
        empirical = math.inf
        if self.rounds_done >= self.min_empirical_rounds:
            empirical = empirical_error_bound(
                self.params,
                n=self.n,
                round_sizes=self.round_sizes,
                round_scores=[h[i] for h in self._history],
                confidence=self.confidence,
            )
        return analytic, empirical

    def _freeze(self, i: int, name: str, bound: float) -> None:
        self._scores[i] = (self._carry[i] / self.walks).astype(np.float32)
        self.certificates[i] = Certificate(
            name=name, bound=float(bound),
            walks=self.walks, rounds=self.rounds_done,
        )

    def absorb(self, n_round: int, rows: np.ndarray) -> None:
        """Fold one served round into the carry; certify + freeze queries.

        ``rows`` is the backend's ``[Q, n]`` single-source score matrix for
        this round alone (each row the mean over ``n_round`` fresh walks).
        Frozen queries ignore their row — their answer was fixed the round
        their certificate fired.
        """
        rows = np.asarray(rows, np.float32)
        if rows.shape != (self.q, self.n):
            raise ValueError(
                f"round rows have shape {rows.shape}, "
                f"want {(self.q, self.n)}"
            )
        self.round_sizes.append(int(n_round))
        self.walks += int(n_round)
        self._history.append(rows)
        self._carry += float(n_round) * rows.astype(np.float64)
        for i in range(self.q):
            if self.certificates[i] is not None:
                continue
            analytic, empirical = self._bounds(i)
            if analytic <= self.epsilon:
                self._freeze(i, "analytic", min(analytic, empirical))
            elif empirical <= self.epsilon:
                self._freeze(i, "empirical", empirical)

    def finish(self, reason: str = "budget") -> None:
        """Freeze every still-live query with the best achieved bound.

        ``reason`` is ``budget`` (schedule cap reached without certifying)
        or ``deadline`` (escalation clamped by straggler shedding) — the
        query degrades to its best-so-far answer instead of raising.
        """
        if self.rounds_done == 0:
            raise RuntimeError("cannot finish before any round was absorbed")
        for i in range(self.q):
            if self.certificates[i] is None:
                analytic, empirical = self._bounds(i)
                self._freeze(i, reason, min(analytic, empirical))

    def result(self, i: int) -> tuple[np.ndarray, Certificate]:
        """(combined scores [n] float32, certificate) for query ``i``."""
        cert = self.certificates[i]
        if cert is None:
            raise RuntimeError(
                f"query {i} is not frozen yet (call finish() after the "
                "escalation loop)"
            )
        return self._scores[i], cert


class ProbeCache:
    """Per-round probe score rows for hub nodes, shared across queries.

    Keyed on ``(node, graph version, round, round size, lane width)`` —
    everything that determines the row bitwise for a node-keyed seed
    stream.  Insertion-ordered eviction bounds memory; a new graph version
    clears the whole cache (every held row is stale by construction).
    """

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._rows: dict[tuple, np.ndarray] = {}
        self._version: int | None = None
        self.hits = 0
        self.misses = 0

    def _sync_version(self, version: int) -> None:
        if self._version != version:
            self._rows.clear()
            self._version = version

    def get(self, key: tuple) -> np.ndarray | None:
        self._sync_version(key[1])
        row = self._rows.get(key)
        if row is None:
            self.misses += 1
            return None
        self.hits += 1
        return row

    def put(self, key: tuple, row: np.ndarray) -> None:
        self._sync_version(key[1])
        if key not in self._rows and len(self._rows) >= self.max_entries:
            # evict the oldest insertion: hub traffic is heavy-tailed, so
            # the hot keys re-enter immediately and stay resident
            self._rows.pop(next(iter(self._rows)))
        self._rows[key] = row

    def __len__(self) -> int:
        return len(self._rows)
