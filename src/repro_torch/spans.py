"""Program spans: ``torch.profiler.record_function`` ranges named
``<layer>.<phase>``, opened only while a profiler records.

``span(name)`` is the port's one way to mark a phase.  With the profiler
off it returns one shared ``nullcontext`` and makes no
``record_function`` call (which costs microseconds even with the profiler
off), so a span on a per-level path costs one flag check.

Spans are flat: no span opens inside another, so a profile's idle gap
falls in at most one of them and is put down to that phase.

| span | opened in | once per | read by |
|---|---|---|---|
| ``fused_serve.draw`` | ``core/multisource.py::fused_serve``: the walk pool's uniforms, the walks, their lengths | batch | ``portbench/metrics/walk_draw_ms.py`` |
| ``fused_serve.level`` | ``fused_serve``'s loop body: refill, frontier, thresholds, the level's push (``lane_probe``), the position update | level | ``portbench/metrics/level_issue_ms.py`` |
| ``fused_serve.continue`` | ``fused_serve``: ``lane_continue``, the loop's one device-to-host read a level | level | ``portbench/metrics/level_sync_ms.py`` |
| ``fused_serve.epilogue`` | ``fused_serve``: the safety-net flush and ``serve_epilogue`` | batch | idle-gap labels of ``portbench``'s breakdown |
| ``serve_step.push`` | ``core/distributed.py::probe_walks_sharded``: each ``coo_push`` (on a ``ShardedGraph`` one ``spmm_csr`` launch a block; else the ``index_add_`` push) | push level | idle-gap labels of ``portbench``'s breakdown |
| ``train_step.forward`` | ``training/step.py``: each forward pass | microbatch | ``chip_smoke.py::profile_train`` |
| ``train_step.update`` | ``training/step.py``: the optimizer's update | step | ``chip_smoke.py::profile_train`` |

``core/epoch.py`` serves through ``fused_serve``, so an epoch carries its
spans.  ``tests/test_torch_spans.py`` holds the counts and the flatness.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager for span ``name``: a ``record_function`` range while
    a profiler records, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
