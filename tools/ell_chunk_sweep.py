#!/usr/bin/env python3
"""Time the ELL kernels on the HepPh table at several chunk sizes.

    python3 tools/ell_chunk_sweep.py    # from the repository root; one CUDA card

This is how ``CHUNK_SLOTS`` of ``src/repro_torch/kernels/ell_plan.py`` was
chosen; run it again when the design of ``lane_probe.cu``, ``spmm_ell.cu``
or ``ell_chunks.cuh`` changes.  For each chunk size it prints the device
time of one lane_probe level at the SimRank path's shape (R = n = 34,546,
W = 256 fp32, prune on) and of one spmm_ell at B = 64, timed and fed as
``chip_smoke.py`` times and feeds them.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402  (its timing and input helpers)

SLOTS = (64, 128, 256, 512, 2048)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ell_chunk_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from repro_torch.api import GraphHandle
    from repro_torch.core import make_params
    from repro_torch.graph import paper_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.lane_probe.ops import lane_probe_level
    from repro_torch.kernels.spmm_ell.ops import spmm_ell_padded

    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    src, dst, n = paper_dataset("hepph", 1.0)
    eg = GraphHandle.from_edges(src, dst, n, device=dev).eg
    deg = eg.in_deg
    w_push = eg.inv_in_deg * make_params(n).sqrt_c
    full = cs.lane_inputs(gen, eg.in_nbrs, n + 1, 256, dtype=torch.float32,
                          n_live=n)
    full["weights"] = w_push
    scores = torch.rand((n + 1, 64), generator=gen, device=dev)
    scores[n] = 0.0
    for c in SLOTS:
        with cs.chunk_slots(c):
            lane = cs.time_ms(lambda: lane_probe_level(
                **full, row_len=deg, row0=0, tab0=0, n_live=n, prune=True), 20)
            spmm = cs.time_ms(lambda: spmm_ell_padded(
                eg.in_nbrs, scores, w_push, row_len=deg), 20)
        cs.log(f"chunk_slots={c}: lane_probe {lane:.4f} ms, spmm_ell {spmm:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
