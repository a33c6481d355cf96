"""Host issue time a probe level leaves the device idle: over the traced
batches, the wall time of the program's ``fused_serve.level`` spans
(refill, frontier, thresholds, the ``lane_probe`` launch, the position
update) less the time some device interval ran inside them, divided by
the spans (profiler)."""

from portbench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx["trace"], "fused_serve.level")
