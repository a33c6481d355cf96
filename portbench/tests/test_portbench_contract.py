"""The benchmark's files against its contract: no JAX or JAX package
anywhere under portbench/, no program in the reference, and every name in
BENCHMARK.json backed by its file."""
from __future__ import annotations

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.toy import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set[str]:
    """Top-level module names a file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_or_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & (FORBIDDEN | {"repro_torch"})


def test_the_top_level_compare_is_whole():
    # repro_torch begins with repro's name and is allowed; repro is not
    assert "repro_torch" not in FORBIDDEN
    assert imported_tops(PB / "harness.py") & {"portbench"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# the cells of accepted benchmarks: a later one may add cells, not lose these
ACCEPTED = {"hepph.topk_bulk", "twitter32.serve_batch"}


def cell_faults(bench: dict, root: Path, cell: dict) -> list[str]:
    """What one cell of ``bench`` lacks: its name, its card count, its
    files and the metrics it reports."""
    pb, name, out = root / "portbench", cell["name"], []
    confs = {c["name"]: c for c in bench["configs"]}
    if name != f"{cell['config']}.{cell['traffic']}":
        out.append(f"{name}: not named <config>.<mix>")
    if cell["chips"] not in (1, 4):
        out.append(f"{name}: chips {cell['chips']}, not 1 or 4")
    if cell["config"] not in confs:
        return out + [f"{name}: no config {cell['config']}"]
    cfg_file = root / confs[cell["config"]]["file"]
    mix_file = pb / "traffic" / f"{cell['traffic']}.json"
    for path in (cfg_file, mix_file, pb / "limits" / f"{name}.json"):
        if not path.is_file():
            out.append(f"{name}: no {path.relative_to(root)}")
    if mix_file.is_file():
        mix = json.loads(mix_file.read_text())
        if not (pb / "entries" / f"{mix['entry']}.py").is_file():
            out.append(f"{name}: no entries/{mix['entry']}.py")
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    if "setup_s" not in e2e or len(e2e) < 2:
        out.append(f"{name}: reports end-to-end {sorted(e2e)}")
    if not any(name in m.get("workloads", [name]) for m in bench["per_layer"]):
        out.append(f"{name}: reports no per-layer metric")
    return out


def contract_faults(root: Path) -> list[str]:
    """What breaks the benchmark's contract in ``root``'s ``BENCHMARK.json``
    and ``portbench/``, for any number of cells: empty when it holds."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb, out = root / "portbench", []
    if set(bench) != {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}:
        out.append(f"keys {sorted(bench)}")
    if bench["paths"] != ["portbench"]:
        out.append(f"paths {bench['paths']}")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e or len(e2e) < 2:
        out.append(f"end-to-end metrics {sorted(e2e)}")
    cells = [w["name"] for w in bench["workloads"]]
    if not 1 <= len(cells) <= 24 or len(set(cells)) != len(cells):
        out.append(f"cells {cells}")
    if not ACCEPTED <= set(cells):
        out.append(f"accepted cells gone: {sorted(ACCEPTED - set(cells))}")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    if four > max(1, len(cells) // 4):
        out.append(f"{four} of {len(cells)} cells on four cards")
    for w in bench["workloads"]:
        out += cell_faults(bench, root, w)
    files = [c["file"] for c in bench["configs"]]
    if len(set(files)) != len(files):
        out.append(f"config files shared: {files}")
    for c in bench["configs"]:
        if not NAME.match(c["name"]) or not any(w["config"] == c["name"]
                                                for w in bench["workloads"]):
            out.append(f"config {c['name']}: misnamed or used by no cell")
    for kind, ms in (("end_to_end", bench["end_to_end"]), ("metrics", bench["per_layer"])):
        for m in ms:
            if not (NAME.match(m["name"]) and UNIT.match(m["unit"])
                    and m["better"] in ("lower", "higher")):
                out.append(f"metric {m['name']}: name, unit or better")
            if not set(m.get("workloads", cells)) <= set(cells):
                out.append(f"metric {m['name']}: lists a cell that is not there")
            if not (pb / kind / f"{m['name'].split('.')[0]}.py").is_file():
                out.append(f"metric {m['name']}: no reader under {kind}/")
    for m in bench["end_to_end"]:
        if not (0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")):
            out.append(f"metric {m['name']}: bound or source")
    for m in bench["per_layer"]:
        # each cell that lists the metric reports the metric it moves
        moved = e2e.get(m["moves"], {})
        if not moved or not set(m["workloads"]) <= set(moved.get("workloads", cells)):
            out.append(f"metric {m['name']}: moves {m['moves']} where it is not reported")
        if m["source"] not in ("device_trace", "program_span", "program_counter",
                               "host_clock"):
            out.append(f"metric {m['name']}: source {m['source']}")
    return out


def test_names_units_and_keys():
    assert contract_faults(ROOT) == []


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(cell):
    assert cell_faults(BENCH, ROOT, cell) == []
    conf = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert key in cfg and key in cfg.get("published", {})
    # a generated graph is a stand-in, and says so
    if cfg.get("graph", {}).get("model") == "zipf":
        assert {"graph", "alpha", "max_deg"} <= set(cfg["assumed"])
    mix = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert mix["check_units"] >= 1
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    # each limit is a number, with the readings it was set from
    assert limits["limits"] and limits["set_from"]
    assert all(NAME.match(k) and v >= 0 for k, v in limits["limits"].items())
    if cell["name"] in ACCEPTED:
        assert "topk_gap" in limits["limits"]


# -- an addition: a cell on four cards, as new files and entries only ------


def copy_benchmark(dst: Path) -> dict[str, str]:
    """``BENCHMARK.json`` and ``portbench/`` copied to ``dst``; returns a
    digest of every file copied, by its path there."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(PB, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return digests(dst)


def digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def add_toy_cell(root: Path, *, chips: int = 4) -> str:
    """Adds cell ``toy4.cards`` as new files and entries only: config, mix,
    entry, limits, and its name in the lists of the metrics it reports."""
    pb, cell = root / "portbench", "toy4.cards"
    (pb / "configs" / "toy4.json").write_text(json.dumps({"name": "toy4", "n": 64}))
    (pb / "traffic" / "cards.json").write_text(json.dumps(
        {"why": "toy", "entry": "toy_cards", "check_units": 2, "trace_units": 1}))
    shutil.copy(PB / "tests" / "toy_cards_entry.py", pb / "entries" / "toy_cards.py")
    (pb / "limits" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"gap": 1e-4, "cards_short": 0}, "set_from": "toy"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy4", "source": "toy", "reduced": [],
                             "file": "portbench/configs/toy4.json", "why": "toy"})
    bench["workloads"].append({"name": cell, "config": "toy4", "traffic": "cards",
                               "chips": chips, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("topk_queries_per_s.step", "device_idle_pct.step"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return cell


RUN_TOY = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from portbench import harness
torch.set_num_threads(1)
for trace in (False, True):
    out = harness.run_cell(sys.argv[2], 3_000_000_019, 0.05, trace, device="cpu",
                           log=lambda msg: None)
    print(json.dumps(out))
"""


def test_a_four_card_cell_is_added_without_an_edit(tmp_path):
    before = copy_benchmark(tmp_path)
    cell = add_toy_cell(tmp_path)
    assert contract_faults(tmp_path) == []
    proc = subprocess.run([sys.executable, "-c", RUN_TOY, str(tmp_path), cell],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    plain, traced = (json.loads(line) for line in proc.stdout.splitlines()[-2:])
    for out in (plain, traced):
        assert out["correct"], out["checks"]
        # the entry got four devices, and the line counts four cards
        assert out["checks"]["cards_short"]["value"] == 0
        assert out["device"]["count"] == 4
    assert set(plain["metrics"]) == {"topk_queries_per_s.step", "setup_s"}
    assert "busy_s" in traced["device"]
    after = digests(tmp_path)
    assert {p for p in before if after.get(p) != before[p]} == {"BENCHMARK.json"}


def drop_twitter(root: Path) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"] = [w for w in bench["workloads"] if w["config"] != "twitter32"]
    bench["configs"] = [c for c in bench["configs"] if c["name"] != "twitter32"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != "twitter32.serve_batch"]
    bench["end_to_end"] = [m for m in bench["end_to_end"] if m.get("workloads", [1])]
    bench["per_layer"] = [m for m in bench["per_layer"] if m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def two_of_three_on_four(root: Path) -> None:
    add_toy_cell(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][1]["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def no_limits(root: Path) -> None:
    (root / "portbench" / "limits" / f"{add_toy_cell(root)}.json").unlink()


REFUSED = {
    "two_of_three_on_four": (two_of_three_on_four, "2 of 3 cells on four cards"),
    "two_chips": (lambda root: add_toy_cell(root, chips=2),
                  "toy4.cards: chips 2, not 1 or 4"),
    "no_limits": (no_limits, "toy4.cards: no portbench/limits/toy4.cards.json"),
    "accepted_cell_dropped": (drop_twitter,
                              "accepted cells gone: ['twitter32.serve_batch']"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_contract_refuses(tmp_path, case):
    change, fault = REFUSED[case]
    copy_benchmark(tmp_path)
    change(tmp_path)
    assert contract_faults(tmp_path) == [fault]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    from portbench.harness import reader

    assert callable(reader("metrics", metric["name"]).read)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_each_end_to_end_metric_has_a_reader(metric):
    from portbench.harness import reader

    assert callable(reader("end_to_end", metric["name"]).read)


@pytest.mark.parametrize("entry", sorted(p.stem for p in (PB / "entries").glob("*.py")
                                         if p.stem != "__init__"))
def test_each_entry_has_the_cell_protocol(entry):
    from portbench.harness import entry as find

    cell = find(entry)
    for attr in ("warm", "unit", "walks", "attempted", "facts", "counters",
                 "free", "compared"):
        assert callable(getattr(cell, attr)), attr


def test_run_refuses_without_a_card():
    """No CUDA card here: run.py exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload", "hepph.topk_bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
