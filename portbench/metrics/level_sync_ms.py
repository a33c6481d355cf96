"""The continue read's idle time a probe level: over the traced batches,
the wall time of the program's ``fused_serve.continue`` spans (the
``.item()`` of ``lane_continue``) less the time some device interval ran
inside them, divided by the spans (profiler)."""

from portbench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx["trace"], "fused_serve.continue")
