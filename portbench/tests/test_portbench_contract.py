"""The benchmark's files against its contract: no JAX or JAX package
anywhere under portbench/, no program in the reference, and every name in
BENCHMARK.json backed by its file."""
from __future__ import annotations

import ast
import json
import re
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


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(BENCH["end_to_end"]) >= 2
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in BENCH["workloads"]]
    assert cells == ["hepph.topk_bulk", "twitter32.serve_batch"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        # each cell that lists the metric reports the metric it moves
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(cell):
    conf = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert key in cfg and key in cfg.get("published", {})
    # the degree law is a stand-in, and says so
    assert {"graph", "alpha", "max_deg"} <= set(cfg["assumed"])
    mix = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "entries" / f"{mix['entry']}.py").exists()
    assert mix["check_units"] >= 1
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    assert "topk_gap" in limits["limits"]
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


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
