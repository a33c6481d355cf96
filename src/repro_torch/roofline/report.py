"""Render the dry-run's tables from its records (port of
``repro.roofline.report``).

Usage:  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun

The records are ``launch/dryrun.py``'s: per device, counted op by op
(``roofline/analysis.py``), against the H100's peaks (``launch.mesh.HW``).
The dry-run compiles nothing, so the records table shows the counting
time where the reference shows the compile time.
"""
from __future__ import annotations

import json
import os
import sys

MOVE_HINTS = {
    ("lm", "compute"): "tensor-core flash at dh 128 and 64 (ROADMAP queue 2 items 10-11); bf16 logits",
    ("lm", "memory"): "decode attention over kv_len only, not the whole cache (queue 2 item 12)",
    ("lm", "collective"): "overlap the tensor-parallel reductions with the GEMMs over NVLink",
    ("gnn", "memory"): "fuse gather + segment sum (a probe_push-style ELL kernel); bf16 features",
    ("gnn", "collective"): "partition edges by destination so scatters stay on their card",
    ("gnn", "compute"): "ELL-pack hot rows for the tensor cores",
    ("recsys", "memory"): "embedding-row gather is the hot path: cache hot rows",
    ("recsys", "collective"): "two-phase all-to-all over NVLink for table-parallel lookups",
    ("recsys", "compute"): "batch MLP is tiny; nothing to do",
    ("probesim", "collective"): "ring push over NVLink + bf16 frontier (push_mode=ring, frontier_dtype)",
    ("probesim", "memory"): "spmm_csr reads each live edge's source row: skip the frontier's zero rows in early levels; lane_probe / spmm_ell read live slots only",
    ("probesim", "compute"): "frontier-sparsity-aware early levels",
}


def family_of(arch: str) -> str:
    if arch in ("gin-tu", "gcn-cora", "gatedgcn", "nequip"):
        return "gnn"
    if arch == "wide-deep":
        return "recsys"
    if arch == "probesim":
        return "probesim"
    return "lm"


def load_records(out_dir: str) -> list[dict]:
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json") or "FAILED" in name:
            continue
        with open(os.path.join(out_dir, name)) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    rows = [
        "| arch | shape | compute | memory | collective | bottleneck | "
        "MODEL_FLOPS | useful/HLO | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or not r.get("applicable", True):
            continue
        if "compute_s" not in r:
            continue
        fam = family_of(r["arch"])
        hint = MOVE_HINTS.get((fam, r["bottleneck"]), "")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['model_flops']:.2e} | "
            f"{r['useful_flops_ratio']:.2f} | {hint} |"
        )
    return "\n".join(rows)


def skip_table(out_dir: str) -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    for name in sorted(os.listdir(out_dir)):
        if name.endswith("__skip.json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            rows.append(f"| {r['arch']} | {r['shape']} | {r['skip_reason']} |")
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    rows = [
        "| arch | shape | mesh | flops/dev | bytes/dev | coll bytes/dev | "
        "mem/dev (arg+tmp GB) | fits 80 GB | count |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if "hlo_flops" not in r:
            continue
        mem = r.get("memory_per_device") or {}
        mem_s = (
            f"{mem.get('argument_gb', 0):.1f}+{mem.get('temp_gb', 0):.1f}"
            if mem else "-"
        )
        name = r["shape"] + (f" ({', '.join(f'{k}={v}' for k, v in r['overrides'].items())})"
                             if r.get("overrides") else "")
        rows.append(
            f"| {r['arch']} | {name} | {r['mesh']} | "
            f"{r['hlo_flops']:.2e} | {r['hlo_bytes']:.2e} | "
            f"{r['collective_bytes']:.2e} | {mem_s} | "
            f"{'yes' if r.get('fits_hbm') else 'no'} | {r.get('count_s', 0):.0f}s |"
        )
    return "\n".join(rows)


def pick_hillclimb(recs: list[dict]) -> list[str]:
    singles = [
        r for r in recs
        if r.get("mesh") == "single" and "compute_s" in r
        and r.get("applicable", True)
    ]
    if not singles:
        return []
    worst_useful = min(
        (r for r in singles if r["model_flops"] > 0),
        key=lambda r: r["useful_flops_ratio"],
    )
    coll_bound = max(
        singles,
        key=lambda r: r["collective_s"] / max(
            r["compute_s"] + r["memory_s"], 1e-12),
    )
    paper = next((r for r in singles if r["arch"] == "probesim"), None)
    out = []
    for label, r in [("worst useful-flops ratio", worst_useful),
                     ("most collective-bound", coll_bound),
                     ("paper-representative", paper)]:
        if r is not None:
            out.append(f"{label}: {r['arch']} x {r['shape']} "
                       f"(bottleneck={r['bottleneck']}, "
                       f"useful={r['useful_flops_ratio']:.2f})")
    return out


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    recs = load_records(out_dir)
    print("## Dry-run records\n")
    print(dryrun_table(recs))
    print("\n## Roofline (256 blocks, one H100 each)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline (512 blocks, one H100 each)\n")
    print(roofline_table(recs, "multi"))
    print("\n## Skipped cells\n")
    print(skip_table(out_dir))
    print("\n## Hillclimb candidates\n")
    for line in pick_hillclimb(recs):
        print("*", line)


if __name__ == "__main__":
    main()
