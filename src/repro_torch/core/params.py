"""Error-budget accounting for ProbeSim (paper Thm 1 + Thm 2).

A copy of ``repro.core.params`` (pure Python; pinned equal by
``tests/test_torch_graph.py``).

Theorem 2: with sampling error eps, pruning parameter eps_p and truncation
parameter eps_t, the total absolute error is bounded by eps_a when

    eps + (1 + eps) / (1 - sqrt(c)) * eps_p + eps_t / 2  <=  eps_a .

We split the budget eps_a as (1/2, 1/4, 1/4) over (sampling, pruning,
truncation) by default — the same shape as the paper's experimental settings
(eps_t = eps_p ~ eps_a/2 at eps_a = 0.1 in their running example).

Number of trials (Alg. 1 line 1):  n_r = ceil(3 c / eps^2 * ln(n / delta)).
Truncation depth (Pruning rule 1): l_t = ceil(log eps_t / log sqrt(c)).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ProbeSimParams:
    c: float  # SimRank decay factor
    eps_a: float  # total absolute error target
    delta: float  # failure probability
    eps: float  # sampling error share
    eps_p: float  # pruning-rule-2 threshold
    eps_t: float  # pruning-rule-1 (truncation) share
    n_r: int  # number of sqrt(c)-walk trials
    max_len: int  # l_t: max walk length (number of NODES, u_1..u_{l_t})
    truncation_shift: bool = False  # add eps_t/2 to estimates (one-sided fix)

    @property
    def sqrt_c(self) -> float:
        return math.sqrt(self.c)


def sampling_error(params: ProbeSimParams, *, n: int, n_r: int) -> float:
    """Thm-1 sampling error a pool of ``n_r`` walks actually guarantees:
    ``eps(n_r) = sqrt(3 c ln(n / delta) / n_r)`` (the inversion of
    ``n_r = ceil(3c/eps^2 ln(n/delta))``)."""
    if n_r < 1:
        raise ValueError(f"n_r must be >= 1, got {n_r}")
    return math.sqrt(3.0 * params.c * math.log(n / params.delta) / n_r)


def bound_from_sampling_error(params: ProbeSimParams, eps: float) -> float:
    """Thm-2 total bound for a given sampling error share ``eps``:
    the pruning and truncation shares stack on top as
    ``eps + (1 + eps) / (1 - sqrt(c)) * eps_p + eps_t / 2``.  Also how an
    *empirical* sampling CI converts into a total certified bound — the
    certificates differ only in the sampling term."""
    return (
        eps
        + (1.0 + eps) / (1.0 - params.sqrt_c) * params.eps_p
        + params.eps_t / 2.0
    )


def abs_error_bound(
    params: ProbeSimParams, *, n: int, n_r: int | None = None
) -> float:
    """Theorem 1+2 absolute-error bound at the EFFECTIVE walk count.

    Inverting Thm 1 (``n_r = ceil(3c/eps^2 ln(n/delta))``) gives the
    sampling error a pool of ``n_r`` walks actually guarantees,

        eps(n_r) = sqrt(3 c ln(n / delta) / n_r),

    and Thm 2 stacks the pruning and truncation shares on top.  Anytime
    queries (``budget_walks`` < the full Thm-1 budget) therefore report the
    looser bound they really provide; at the full budget this reproduces
    ``params.eps_a`` (up to the ceil slack in n_r).
    """
    r = int(params.n_r if n_r is None else n_r)
    return bound_from_sampling_error(params, sampling_error(params, n=n, n_r=r))


def walks_for_error(
    params: ProbeSimParams, *, n: int, epsilon: float
) -> int | None:
    """Smallest walk count whose Thm-1/2 bound meets ``epsilon`` — or None.

    Solving ``bound_from_sampling_error(params, e) <= epsilon`` for the
    sampling error gives

        e_max = (epsilon - eps_t/2 - kappa) / (1 + kappa),
        kappa = eps_p / (1 - sqrt(c)),

    which is the headroom left after the walk-count-independent pruning
    and truncation floors.  ``None`` when the floors alone exceed epsilon:
    no number of walks can certify it analytically (the adaptive
    controller may still certify via the empirical CI's smaller sampling
    term, but the floors are a hard limit for both certificates).
    """
    if epsilon <= 0.0:
        return None
    kappa = params.eps_p / (1.0 - params.sqrt_c)
    e_max = (epsilon - params.eps_t / 2.0 - kappa) / (1.0 + kappa)
    if e_max <= 0.0:
        return None
    return int(math.ceil(3.0 * params.c * math.log(n / params.delta) / e_max**2))


def make_params(
    n: int,
    c: float = 0.6,
    eps_a: float = 0.1,
    delta: float = 0.01,
    split: tuple[float, float, float] = (0.5, 0.25, 0.25),
    n_r_override: int | None = None,
    max_len_override: int | None = None,
    truncation_shift: bool = False,
) -> ProbeSimParams:
    if not (0.0 < c < 1.0):
        raise ValueError("decay factor c must be in (0,1)")
    ws, wp, wt = split
    assert abs(ws + wp + wt - 1.0) < 1e-9, "budget split must sum to 1"
    sqrt_c = math.sqrt(c)
    eps = eps_a * ws
    # (1+eps)/(1-sqrt(c)) * eps_p = eps_a * wp  =>  solve for eps_p
    eps_p = eps_a * wp * (1.0 - sqrt_c) / (1.0 + eps)
    # eps_t / 2 = eps_a * wt
    eps_t = 2.0 * eps_a * wt
    n_r = n_r_override or int(math.ceil(3.0 * c / eps**2 * math.log(n / delta)))
    max_len = max_len_override or max(
        2, int(math.ceil(math.log(eps_t) / math.log(sqrt_c)))
    )
    # sanity: Theorem 2 inequality holds
    assert eps + (1 + eps) / (1 - sqrt_c) * eps_p + eps_t / 2 <= eps_a + 1e-9
    return ProbeSimParams(
        c=c,
        eps_a=eps_a,
        delta=delta,
        eps=eps,
        eps_p=eps_p,
        eps_t=eps_t,
        n_r=n_r,
        max_len=max_len,
        truncation_shift=truncation_shift,
    )
