"""End-to-end metric readers, one module per metric of ``BENCHMARK.json``,
found by the metric's name up to its first dot (``topk_queries_per_s.step``
is read by ``topk_queries_per_s.py``).

Each module has ``read(ctx) -> float | None``.  ``ctx`` holds ``cell``
(the entry's ``Cell`` after its window), ``elapsed`` (the window's
seconds on the host clock, whole units) and ``setup_s``.
"""
