"""Roofline of a step, counted op by op (port of ``repro.roofline``).

* ``analysis`` — ``OpCounter`` (a ``TorchDispatchMode`` counting FLOPs,
  bytes, collective bytes and live memory on ``cuda``, ``cpu`` or ``meta``
  tensors), the kernels' least-work formulas and ``RooflineReport``;
* ``report``   — the dry-run records rendered as tables.
"""
from repro_torch.roofline.analysis import (
    OpCounter,
    RooflineReport,
    Work,
    analyze,
    flash_work,
    lane_probe_work,
    spmm_work,
)

__all__ = ["OpCounter", "RooflineReport", "Work", "analyze", "flash_work",
           "lane_probe_work", "spmm_work"]
