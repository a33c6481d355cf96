"""One run of one cell: set-up, the measured window, the traced part, the
check against the plain reference, and the result line.

Everything a cell is made of is found by name, so a new cell, loop or
metric is new files and entries, never an edit here: the cell in
``BENCHMARK.json``; its configuration (the ``file`` of its config entry);
its traffic mix (``traffic/<mix>.json``), which names its ``entry``, the
loop under ``entries/<entry>.py``; its limits (``limits/<cell>.json``);
each end-to-end metric's reader (``end_to_end/<metric>.py``) and each
per-layer metric's (``metrics/<metric>.py``), both by the metric's name up
to its first dot.

The window runs units until ``--seconds`` have passed and ends when the
unit in flight ends: rates are taken over whole units and the whole time.
"""
from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from pathlib import Path

import torch

from portbench import check, roofline
from portbench.tracing import Profile, Spans, breakdown, wrap

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ---------------------------------------------------------------------------
# Loading a cell
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, overrides: dict | None = None) -> dict:
    """The cell's entry, config, mix, limits and metric entries."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")["limits"]
    o = overrides or {}
    cfg = {**cfg, **o.get("config", {})}
    mix = {**mix, **o.get("traffic", {})}
    limits = {**limits, **o.get("limits", {})}

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return dict(
        cell=cell, cfg=cfg, mix=mix, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def reader(kind: str, name: str):
    """The reader module of metric ``name``: ``portbench.<kind>.<stem>``."""
    return importlib.import_module(f"portbench.{kind}.{name.split('.')[0]}")


def entry(name: str):
    return importlib.import_module(f"portbench.entries.{name}").Cell


def device_facts(device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1)
    return dict(platform="cpu", kind="cpu", count=1)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, t_start: float | None = None,
             overrides: dict | None = None, control: bool = False,
             log=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_cell(workload, overrides)
    cfg, mix = spec["cfg"], spec["mix"]
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if cuda:
        torch.cuda.set_device(device)
    spans = Spans()
    cell = entry(mix["entry"])(cfg, mix, seed, device, spans, control=control)
    log(f"{workload}: n {cell.n}, m {cell.graph['m']}, n_r {cell.b['n_r']}, "
        f"max_len {cell.b['max_len']}, seed {seed}")
    cell.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    # -- the window --------------------------------------------------------
    facts = cell.facts()
    c0 = cell.counters()
    wrapped, prof, tr = [], None, None
    trace_units = int(mix.get("trace_units", 1)) if trace else 0
    if trace:
        spans.annotate = True
        targets = {}
        for m in spec["per_layer"]:
            targets.update(getattr(reader("metrics", m["name"]), "SPANS", {}))
        for name, target in targets.items():
            undo = wrap(spans, name, target)
            if undo:
                wrapped.append(undo)
        prof = Profile(device)
        prof.start()
    t0 = time.perf_counter()
    window_cm = spans.span("window", sync=True) if trace else None
    if window_cm:
        window_cm.__enter__()
    while True:
        cell.unit()
        if trace and len(cell.units) == trace_units:
            window_cm.__exit__(None, None, None)
            tr = prof.stop()
            spans.annotate = False
            for undo in wrapped:
                undo()
        if time.perf_counter() - t0 >= seconds and (not trace or tr is not None):
            break
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counters = {k: v - c0.get(k, 0) for k, v in cell.counters().items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    units = len(cell.units)
    log(f"window: {units} units in {elapsed:.3f} s ({elapsed / units * 1e3:.1f} ms "
        f"a unit); setup {setup_s:.3f} s; counters {counters}")

    # -- the check ----------------------------------------------------------
    cell.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, missing = cell.compared(seed)
    correct, shown = check.verdict(numbers, spec["limits"], missing=missing)
    log(f"check: units picked {check.pick_units(seed, units, mix['check_units'])} "
        f"against the reference in {time.perf_counter() - t_check:.3f} s")

    # -- the result line -----------------------------------------------------
    dev = dict(device_facts(device), memory_peak_bytes=int(peak))
    metrics = {}
    if not trace:
        ctx = dict(cell=cell, elapsed=elapsed, setup_s=setup_s)
        for m in spec["end_to_end"]:
            v = reader("end_to_end", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lo, hi = tr.window if tr.window else (0, 0)
        dev.update(busy_s=tr.busy(lo, hi), window_s=(hi - lo) / 1e9)
        ctx = dict(trace=tr, spans=spans, facts=facts, units=units,
                   counters=counters, peak_bw=roofline.hbm_peak(dev["kind"]),
                   window=(lo, hi))
        for m in spec["per_layer"]:
            v = reader("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"trace: {trace_units} units, {len(tr.kernels)} device intervals, "
            f"profiler stop {tr.exit_s:.3f} s")
    out = dict(correct=correct, attempted=cell.attempted(),
               failed=cell.failed + missing, metrics=metrics, device=dev)
    if trace and tr.window:
        out["breakdown"] = breakdown(tr, *tr.window)
    out["checks"] = shown
    return out


def print_checks(shown: dict) -> None:
    for name, d in shown.items():
        print(f"check {name}: {d['value']} (limit {d['limit']})",
              file=sys.stderr, flush=True)
