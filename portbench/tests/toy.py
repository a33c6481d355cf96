"""Toy sizes of the cells for the CPU tests: the same code paths as the
card's runs, with graphs of a few hundred nodes and eps_a 0.3."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

HEPPH = {"config": {"n": 300, "m": 2000, "eps_a": 0.3,
                    "graph": {"model": "zipf", "alpha": 1.1, "max_deg": 30}},
         "traffic": {"batch_q": 4, "walk_chunk": 256, "trace_units": 1}}
TWITTER = {"config": {"n": 256, "m": 1800, "eps_a": 0.3,
                      "graph": {"model": "zipf", "alpha": 1.1, "max_deg": 40}},
           "traffic": {"queries": 2, "walk_chunk": 32}}
TOY = {"hepph.topk_bulk": HEPPH, "twitter32.serve_batch": TWITTER}
SEED = 3_000_000_019  # past 32 signed bits: seeds of any size are taken


def run(cell: str, *, seconds: float = 0.2, trace: bool = False,
        control: bool = False, seed: int = SEED, traffic: dict | None = None) -> dict:
    import torch

    from portbench import harness

    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: a thread pool beside other workers only waits
    toy = TOY[cell]
    overrides = {**toy, "traffic": {**toy["traffic"], **(traffic or {})}}
    try:
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                overrides=overrides, control=control,
                                log=lambda msg: None)
    finally:
        torch.set_num_threads(threads)
