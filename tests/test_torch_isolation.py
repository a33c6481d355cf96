"""repro_torch stands alone: it imports neither jax nor repro, and its entry
points never choose the CPU on their own."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

PKG = Path(repro_torch.__file__).resolve().parent


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="repro_torch.")
    )


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.lane_probe.ops" in mods
    assert "repro_torch.api.session" in mods
    for new in ("repro_torch.arch", "repro_torch.configs.base",
                "repro_torch.configs.llama3_2_1b", "repro_torch.models.common",
                "repro_torch.models.transformer.attention",
                "repro_torch.models.transformer.model",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.probe_push.ops",
                "repro_torch.kernels.probe_push.ref",
                "repro_torch.kernels.ell_plan", "repro_torch.graph.dynamic",
                "repro_torch.core.epoch", "repro_torch.core.metrics",
                "repro_torch.core.accuracy", "repro_torch.core.power",
                "repro_torch.core.montecarlo", "repro_torch.core.probe_random",
                "repro_torch.core.tsf", "repro_torch.core.pooling",
                "repro_torch.serving", "repro_torch.serving.protocol",
                "repro_torch.serving.straggler", "repro_torch.serving.service",
                "repro_torch.serving.server", "repro_torch.serving.engine",
                "repro_torch.serving.dynamic_engine", "repro_torch.streams",
                "repro_torch.streams.events", "repro_torch.streams.churn",
                "repro_torch.streams.driver", "repro_torch.launch.serve",
                "repro_torch.examples.quickstart", "repro_torch.launch.mesh",
                "repro_torch.graph.partition", "repro_torch.core.distributed",
                "repro_torch.core.ring", "repro_torch.configs.probesim",
                "repro_torch.graph.io",
                "repro_torch.examples.distributed_serve_demo",
                "repro_torch.examples.dynamic_graph_serving",
                "repro_torch.roofline", "repro_torch.roofline.analysis",
                "repro_torch.roofline.report", "repro_torch.launch.dryrun",
                "repro_torch.configs.yi_34b", "repro_torch.configs.llama3_405b",
                "repro_torch.models.transformer.moe",
                "repro_torch.configs.deepseek_v2_lite_16b",
                "repro_torch.configs.qwen2_moe_a2_7b"):
        assert new in mods, new
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok', len(sys.modules))\n"
    )
    src = str(PKG.parent)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"},
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_no_jax_or_repro_import_statements():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(PKG)}: {name}")
    assert not offenders, offenders


def test_entry_points_default_to_cuda():
    """Without device= an entry point targets CUDA; with no card it raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.api import GraphHandle
    from repro_torch.graph import ell_from_edges, graph_from_edges, toy_graph
    from repro_torch.graph.convert import graph_from_arrays

    from repro_torch.serving import SimRankService
    from repro_torch.streams import SlidingWindowExpirer, frozen_window_handle

    src, dst, n = toy_graph()
    expirer = SlidingWindowExpirer(ttl=0.5)
    expirer.ingest([0.1], [0], [1])
    for call in (
        lambda: GraphHandle.from_edges(src, dst, n),
        lambda: graph_from_edges(src, dst, n),
        lambda: ell_from_edges(src, dst, n),
        lambda: graph_from_arrays(src=src, dst=dst, n=n),
        # the service serves where its handle lives: the card by default
        lambda: SimRankService(GraphHandle.from_edges(src, dst, n)),
        lambda: frozen_window_handle(src, dst, n),
        lambda: expirer.expire_batches(1.0, batch_size=4, n=n),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    h = GraphHandle.from_edges(src, dst, n, device="cpu")
    assert h.device.type == "cpu" and isinstance(h.g.src, torch.Tensor)
    assert np.array_equal(h.to_host_edges()[0], src)
