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

Adding a cell, on one card or four, is exactly this and nothing else:

* new files: the configuration (``configs/<config>.json``), the mix
  (``traffic/<mix>.json``), an entry (``entries/<entry>.py``) only where
  no loop there drives the cell, the limits (``limits/<cell>.json``), and
  a reader for each new metric;
* in ``BENCHMARK.json``: new ``configs`` and ``workloads`` entries (the
  cell is named ``<config>.<mix>`` and asks for 1 or 4 ``chips``) and
  new ``per_layer`` entries;
* the new cell's name appended to the ``workloads`` list of each metric
  it reports.

A cell runs on its first ``chips`` cards, which its entry gets as
``devices``; every one of them is synchronised at the window's ends and
measured: the peak memory of the fullest, and ``busy_s`` as the mean of
the cards' busy time.

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
from portbench.tracing import Profile, Spans, breakdown, synchronize, wrap

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


def cell_devices(device, chips: int) -> list[torch.device]:
    """The cell's ``chips`` cards, ``cuda:0`` .. ``cuda:chips-1``; on a
    device that is not CUDA (the CPU tests), ``chips`` times that device."""
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        return [device] * chips
    return [torch.device("cuda", i) for i in range(chips)]


def device_facts(devices) -> dict:
    if devices[0].type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(devices[0]),
                    count=len(devices))
    return dict(platform="cpu", kind="cpu", count=len(devices))


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
    devices = cell_devices(device, spec["cell"]["chips"])
    device = devices[0]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    spans = Spans(devices)
    cell = entry(mix["entry"])(cfg, mix, seed, device, spans, devices=devices,
                               control=control)
    log(f"{workload}: n {cell.n}, m {cell.graph['m']}, n_r {cell.b['n_r']}, "
        f"max_len {cell.b['max_len']}, seed {seed}, on {[str(d) for d in devices]}")
    cell.warm()
    synchronize(devices)
    if cuda:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
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
        prof = Profile(devices)
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
    synchronize(devices)
    elapsed = time.perf_counter() - t0
    counters = {k: v - c0.get(k, 0) for k, v in cell.counters().items()}
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
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
    dev = dict(device_facts(devices), memory_peak_bytes=int(peak))
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
        for c, busy in tr.busy_by_card(lo, hi).items():
            log(f"trace: card {c}: {tr.card.count(c)} device intervals, "
                f"busy {busy} s of the window")
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
