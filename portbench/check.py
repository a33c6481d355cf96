"""The comparison that decides ``correct``.

The compared number is a worst case over the answers checked:
``topk_gap``, the largest gap, relative to the query's largest reference
score (scores differ by orders of magnitude between queries; the query
node is left out), between the program's top-k and the reference's: at
each returned node, the program's score against the reference's estimate
of that node; and place by place, the reference's estimates of the
returned nodes (sorted) against the reference's own top-k values, which
catches a node that is not among the top k.

The answers compared are those of whole units (a drained batch, a step)
that the run's seed picks among the window's, so a fault confined to one
query slot shows in every unit checked.

A number passes at or under its limit; a run is correct when every number
passes and every due answer came.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import traffic
from portbench.reference.simrank import topk_excluding


def topk_gap(idx, vals, ref_est: torch.Tensor, u: int) -> float:
    """``topk_gap`` of one query's top-k (``idx``, ``vals``) against the
    reference's estimates ``ref_est`` [n] (float64)."""
    k = len(idx)
    ref_vals, _ = topk_excluding(ref_est, u, k)
    ref = ref_est.clone()
    ref[u] = -torch.inf
    at = ref[torch.as_tensor(np.asarray(idx), dtype=torch.long, device=ref.device)]
    got = torch.as_tensor(np.asarray(vals), dtype=ref.dtype, device=ref.device)
    scale = float(ref_vals[0]) if float(ref_vals[0]) > 0 else 1.0
    score = float((got - at).abs().max())
    place = float((torch.sort(at, descending=True).values - ref_vals).abs().max())
    return max(score, place) / scale


def pick_units(seed: int, count: int, want: int) -> list[int]:
    """``want`` of the window's ``count`` units, drawn from ``seed``."""
    rng = traffic.stream(seed, traffic.SAMPLE)
    return sorted(int(i) for i in rng.choice(count, size=min(want, count),
                                             replace=False)) if count else []


def worst_topk_gap(answers: list[dict], reference) -> float:
    """The largest ``topk_gap`` over ``answers`` (each with ``node``,
    ``idx``, ``vals``); ``reference(a)`` gives answer ``a``'s estimates."""
    gap = 0.0
    for a in answers:
        est = reference(a)
        gap = max(gap, topk_gap(a["idx"], a["vals"], est, a["node"]))
        del est
    return gap


def topk_compared(cell, seed: int) -> tuple[dict, int]:
    """An entry's ``compared`` for top-k answers: ``topk_gap`` over every
    answer of the units ``seed`` picks (``check_units`` of them), against
    ``cell.reference``; one missing answer when the window made none."""
    picked = pick_units(seed, len(cell.units), cell.mix["check_units"])
    answers = [a for i in picked for a in cell.units[i]["answers"]]
    return (dict(topk_gap=worst_topk_gap(answers, cell.reference)),
            0 if answers else 1)


def verdict(numbers: dict, limits: dict, *, missing: int) -> tuple[bool, dict]:
    """``correct`` and the compared numbers beside their limits."""
    shown = {}
    ok = missing == 0
    for name, value in numbers.items():
        lim = limits[name]
        shown[name] = {"value": value, "limit": lim}
        ok = ok and value is not None and value <= lim
    shown["missing_answers"] = {"value": missing, "limit": 0}
    return bool(ok), shown
