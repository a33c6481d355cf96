"""Each fault a cell can have, planted under the timed path on the CPU at
toy size, turns ``correct`` false: a step that leaves its state unchanged,
half of the batch left out with the mean over the rest, and an answer
altered where it is produced, in the first query slot or only in the
last, in windows of several units of which the check compares one.  (No
cell exchanges between chips.)"""
from __future__ import annotations

import pytest
import torch

from portbench.tests.toy import TOY, run


def level_unchanged(monkeypatch):
    import repro_torch.kernels.lane_probe.ops as ops

    def fake(nbrs, weights, table, dep, total, fin, u_p, u_prev, thr, *, out=None,
             tot=None, **kw):
        out.copy_(table[: out.shape[0]])
        tot.copy_(total)
        return out, tot

    fake.launches = 0
    monkeypatch.setattr(ops, "lane_probe_level", fake)


def half_walks(monkeypatch):
    import repro_torch.core.multisource as ms

    real = ms.fused_serve

    def fake(*args, n_r, **kw):
        return real(*args, n_r=n_r // 2, **kw)

    monkeypatch.setattr(ms, "fused_serve", fake)


def altered_answer(monkeypatch, slot=0):
    import repro_torch.core.multisource as ms

    real = ms.topk_rows

    def fake(est, us, k):
        idx, vals = real(est, us, k)
        j = slot % idx.shape[0]
        idx[j, 0] = (idx[j, 0] + 1) % est.shape[1]
        return idx, vals

    monkeypatch.setattr(ms, "topk_rows", fake)


def last_slot_altered(monkeypatch):
    altered_answer(monkeypatch, slot=-1)


def push_unchanged(monkeypatch):
    import repro_torch.core.distributed as dist

    monkeypatch.setattr(dist, "coo_push", lambda fulls, *a, **kw: [f.clone() for f in fulls])


def step_half(monkeypatch):
    import repro_torch.core.distributed as dist

    real = dist.serve_topk

    def fake(scores, query_nodes, *, queries, walk_chunk, top_k):
        half = scores.reshape(scores.shape[0], queries, walk_chunk)[:, :, : walk_chunk // 2]
        return real(half.reshape(scores.shape[0], -1), query_nodes, queries=queries,
                    walk_chunk=walk_chunk // 2, top_k=top_k)

    monkeypatch.setattr(dist, "serve_topk", fake)


def step_altered(monkeypatch, slot=0):
    import repro_torch.core.distributed as dist

    real = dist.serve_topk

    def fake(scores, *a, **kw):
        idx, vals = real(scores, *a, **kw)
        j = slot % idx.shape[0]
        idx[j, 0] = (idx[j, 0] + 1) % scores.shape[0]
        return idx, vals

    monkeypatch.setattr(dist, "serve_topk", fake)


def step_last_slot_altered(monkeypatch):
    step_altered(monkeypatch, slot=-1)


FAULTS = [
    ("hepph.topk_bulk", level_unchanged),
    ("hepph.topk_bulk", half_walks),
    ("hepph.topk_bulk", altered_answer),
    ("hepph.topk_bulk", last_slot_altered),
    ("twitter32.serve_batch", push_unchanged),
    ("twitter32.serve_batch", step_half),
    ("twitter32.serve_batch", step_altered),
    ("twitter32.serve_batch", step_last_slot_altered),
]
WIDTH = {"hepph.topk_bulk": "batch_q", "twitter32.serve_batch": "queries"}


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_turns_correct_false(cell, fault, monkeypatch):
    """The window holds more units than the check compares, so a fault
    caught here is caught in a unit the seed picked, not because every
    answer was compared."""
    torch.manual_seed(0)
    fault(monkeypatch)
    width = TOY[cell]["traffic"][WIDTH[cell]]
    for seconds in (0.3, 1.5, 4.0):  # a slow worker needs a longer window
        out = run(cell, seconds=seconds)
        if out["attempted"] >= 2 * width:
            break
    assert out["attempted"] >= 2 * width
    assert not out["correct"], out["checks"]
