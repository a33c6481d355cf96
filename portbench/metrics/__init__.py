"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``,
found by the metric's name up to its first dot (``device_idle_pct.step``
is read by ``device_idle_pct.py``).

Each module has ``read(ctx) -> float | None``: ``None`` when the run gave
it nothing to read (the harness then leaves the metric out).  A module may
name ``SPANS = {span: "module:function"}``: functions of the program the
traced part puts a benchmark span around.  ``ctx`` holds ``trace`` (a
``tracing.Trace`` of the traced units), ``window`` (its ns bounds),
``spans`` (the benchmark's host spans over the whole window),
``counters`` (the change of the entry's program counters over the
window), ``units``, ``facts`` (sizes of the graph and the lanes at the
window's start) and ``peak_bw``.
"""
