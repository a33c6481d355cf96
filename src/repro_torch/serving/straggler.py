"""Straggler mitigation for distributed query serving (a copy of
``repro.serving.straggler``; ``tests/test_torch_service.py`` runs the
reference's cases through both).

On a large mesh a single slow/failed worker stalls the whole SPMD step.
Mitigations implemented here (host-side policy around the dispatch):

* **deadline + retry**: dispatch with a wall-clock deadline; on miss, retry
  on the replica group (queries are pure -> idempotent);
* **hedged dispatch**: optionally launch the same batch on two replica
  groups and take the first result (classic tail-latency hedging);
* **work shedding**: under deadline pressure, reduce the walk budget of the
  retry (ProbeSim is an anytime estimator — fewer walks = graceful accuracy
  degradation, bounded by Thm 1 with the reduced n_r);
* **adaptive clamping** (:func:`dispatch_adaptive`): an adaptive (epsilon)
  query carries the deadline IN-BAND — the accuracy controller checks it
  between escalation rounds and freezes still-live queries with their
  best-so-far certificate (``certificate='deadline'``) instead of raising,
  so a deadline miss degrades accuracy, not availability.  A thread
  backstop still bounds a genuinely wedged dispatch.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class HedgePolicy:
    deadline_s: float = 5.0
    max_retries: int = 2
    shed_factor: float = 0.5  # walk-budget multiplier per retry
    hedge: bool = False


class DeadlineError(TimeoutError):
    pass


def run_with_deadline(fn: Callable, *args, deadline_s: float, **kwargs):
    """Run fn in a worker thread; raise DeadlineError if it misses."""
    result: list = []
    err: list = []

    def work():
        try:
            result.append(fn(*args, **kwargs))
        except Exception as e:  # pragma: no cover - propagated below
            err.append(e)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout=deadline_s)
    if err:
        raise err[0]
    if not result:
        raise DeadlineError(f"missed {deadline_s}s deadline")
    return result[0]


def dispatch(
    fn: Callable,
    *args,
    policy: HedgePolicy,
    budget_key: str = "budget_walks",
    budget: int | None = None,
    on_retry: Callable[[int], None] | None = None,
    **kwargs,
):
    """Deadline + retry-with-shedding wrapper around a query function."""
    attempt = 0
    cur_budget = budget
    while True:
        try:
            if cur_budget is not None:
                kwargs[budget_key] = max(1, int(cur_budget))
            return run_with_deadline(
                fn, *args, deadline_s=policy.deadline_s, **kwargs
            )
        except DeadlineError:
            attempt += 1
            if attempt > policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt)
            if cur_budget is not None:
                cur_budget = int(cur_budget * policy.shed_factor)


def dispatch_adaptive(
    fn: Callable,
    *args,
    policy: HedgePolicy,
    backstop_factor: float = 4.0,
    **kwargs,
):
    """Deadline wrapper for ADAPTIVE queries: degrade, don't retry.

    Flat-budget dispatch (:func:`dispatch`) can only enforce a deadline
    from outside — kill and re-dispatch with a shed budget.  An adaptive
    query already contains the graceful version of that policy: passing
    ``deadline_s`` in-band lets the escalation loop stop BETWEEN rounds
    and freeze still-live queries with ``certificate='deadline'`` and
    their best-so-far scores, so the caller gets an answer with an honest
    bound instead of an exception.  ``fn`` is typically
    ``session.query`` and must accept a ``deadline_s`` kwarg.

    The worker thread keeps a backstop at ``backstop_factor x deadline_s``
    (a single escalation round that wedges past the whole in-band window
    still gets bounded) — only THAT raises :class:`DeadlineError`.
    """
    if backstop_factor < 1.0:
        raise ValueError(
            f"backstop_factor must be >= 1, got {backstop_factor}"
        )
    def clamped():
        # the IN-BAND deadline the escalation loop honors; the outer
        # deadline_s below is the thread backstop only
        return fn(*args, deadline_s=policy.deadline_s, **kwargs)

    return run_with_deadline(
        clamped, deadline_s=policy.deadline_s * backstop_factor
    )
