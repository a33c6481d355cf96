"""Whole runs of each cell on the CPU at toy size (the harness's look for a
card skipped): the program is correct, its control is not, and a traced
run reads its per-layer metrics and a breakdown."""
from __future__ import annotations

import json

import pytest

from portbench.tests.toy import TOY, run

CELLS = sorted(TOY)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_at_toy_size(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0
    rate = [k for k in out["metrics"] if k.startswith("topk_queries_per_s")]
    assert len(rate) == 1 and out["metrics"][rate[0]]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control (bf16 lane buffers; the bf16-frontier reference in the
    step's place) fails the limits the program passes."""
    out = run(cell, control=True)
    assert not out["correct"]
    assert out["checks"]["topk_gap"]["value"] > out["checks"]["topk_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(cell):
    out = run(cell, trace=True)
    assert out["correct"]
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not any(k.startswith("topk_queries_per_s") for k in out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_answers(cell):
    """Two runs of one seed answer the same queries alike: the inputs, the
    graph and the walk seeds all come from the seed."""
    a = run(cell, seconds=0.0)
    b = run(cell, seconds=0.0)
    assert a["checks"]["topk_gap"] == b["checks"]["topk_gap"]
    assert a["attempted"] == b["attempted"]
