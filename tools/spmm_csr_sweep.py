#!/usr/bin/env python3
"""Time the production push on the Twitter/32 benchmark graph, by layout.

    python3 tools/spmm_csr_sweep.py [--seed N]   # repository root; one CUDA card

Builds the ``twitter32`` configuration's graph (``portbench/configs``) on
the card as the benchmark does, puts it in one ``ShardedGraph`` block and
pushes a random ``[n_pad, 2,048]`` fp32 frontier through:

* the ``index_add_`` push (``core/distributed.py::bucket_push``), the
  yardstick, and the plain version ``spmm_csr_ref`` on the card;
* ``spmm_csr`` at each column layout of ``LAYOUTS`` (columns a tile,
  chunk slots), each checked against the yardstick (largest difference
  over the largest value) and against its own second launch (bit for bit).

This is how the layout of ``kernels/spmm_ell/ops.py::spmm_csr`` (full-row
tiles) was chosen; run it again when ``spmm_ell.cu`` or ``ell_chunks.cuh``
changes.  Device times are
CUDA-event means over a few launches after one warm launch.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

WIDTH = 2048
# (columns a tile, chunk slots): full rows (launch_layout's 1,024 fp32
# columns, two tiles) down to tiles whose [n_pad, tile] frontier slice
# stays in the 50 MB L2 (8 fp32 columns: 41.7 MB at n_pad 1,301,632)
LAYOUTS = (
    (1024, 128), (1024, 256), (1024, 64), (512, 128), (512, 256),
    (32, 1024), (16, 2048), (8, 2048), (8, 1024), (4, 2048),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3_900_000_001)
    ap.add_argument("--layouts", default="", help="indices into LAYOUTS, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmm_csr_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from portbench import deploy
    from repro_torch.core.distributed import (bucket_push, build_sharded_graph,
                                              push_weights)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ell_plan import build_plan, launch_layout
    from repro_torch.kernels.spmm_ell.ops import launch_csr
    from repro_torch.kernels.spmm_ell.ref import spmm_csr_ref
    from repro_torch.launch.mesh import ShardMesh

    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    _build.build_all(("spmm_ell",))
    log(f"built spmm_ell in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "portbench/configs/twitter32.json").read_text())
    g = deploy.make_graph(cfg, args.seed, dev)
    sg = build_sharded_graph(g["src_h"], g["dst_h"], cfg["n"], mesh=ShardMesh([dev]),
                             pad_nodes=cfg["pad_nodes"], pad_edges=cfg["pad_edges"])
    del g
    n_pad, live = sg.n_pad, sg.counts[0]
    deg = sg.in_deg[0]
    log(f"graph: n_pad {n_pad}, live edges {live}, largest in-degree "
        f"{int(deg.max())}, rows with in-degree 0: {int((deg == 0).sum())}")
    w = push_weights(sg, 0.6 ** 0.5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    full = torch.rand((n_pad, WIDTH), generator=gen, device=dev)
    item = full.element_size()
    least = 8 * live + 2 * item * n_pad * WIDTH  # portbench.roofline.push_level_bytes
    gathered = live * WIDTH * item
    log(f"frontier {n_pad * WIDTH * item / 1e9:.2f} GB; least bytes a level "
        f"{least / 1e9:.2f} GB ({least / 3.35e12 * 1e3:.2f} ms at 3.35 TB/s); "
        f"each live edge's source row once: {gathered / 1e9:.1f} GB "
        f"({gathered / 3.35e12 * 1e3:.1f} ms)")

    def yard():
        return bucket_push([full], sg.src_sh, sg.dst_sh, [live], w, rows=n_pad,
                           n_pad=n_pad, edge_chunks=8)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = yard()
    ms = event_ms(yard, 2)
    log(f"index_add_ push: {ms:.2f} ms a level, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    scale = float(ref.abs().max())
    ms = event_ms(lambda: spmm_csr_ref(sg.indices[0], full, w[0], indptr=sg.indptr[0],
                                       row_len=deg, base=sg.base[0]), 1)
    log(f"plain version (spmm_csr_ref): {ms:.2f} ms a level")
    log(f"spmm_csr's layout (vec, tc, tiles): {launch_layout(WIDTH, item, full.data_ptr())}")
    out = torch.empty_like(full)
    out2 = torch.empty_like(full)
    pick = [int(x) for x in args.layouts.split(",") if x] or range(len(LAYOUTS))
    for i in pick:
        cols, slots = LAYOUTS[i]
        vec = 4
        tc = cols // vec
        tiles = WIDTH // cols
        plan = build_plan(deg, max(1, sg.indices[0].shape[0]), chunk_slots=slots)

        def run(o=out):
            launch_csr(sg.indices[0], full, w[0], sg.indptr[0], deg, sg.base[0], o,
                       vec=vec, tc=tc, tiles=tiles, chunk_slots=slots)

        torch.cuda.synchronize()
        ms = event_ms(run, 3)
        run(out2)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) / scale
        same = bool(torch.equal(out, out2))
        log(f"layout {i}: {cols:5d} columns a tile ({tiles} tiles, {256 // tc} slot "
            f"groups), chunk {slots}: {ms:8.2f} ms ({least / 3.35e12 * 1e5 / ms:.2f} % "
            f"of the least-bytes roofline; {gathered / ms / 1e6:.0f} GB/s of "
            f"gathered rows); "
            f"{plan.n_chunks} chunks, {plan.n_pieces} pieces; max diff {err:.2e} "
            f"of the largest; repeat bit for bit: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
