"""Time the walk draw takes a batch: mean over the program's
``fused_serve.draw`` spans (the uniforms, the walks, their lengths) of the
time from the span's start to its own end or to the end of the last
device interval launched inside it, whichever is later; the device's end
taken onto the host's clock (``program_spans.Timeline``) (profiler)."""

from portbench.program_spans import Timeline, ranges


def read(ctx):
    tr = ctx["trace"]
    draws = ranges(tr, "fused_serve.draw")
    if not draws:
        return None
    tl = Timeline(tr)
    ms = 0.0
    for a, b in draws:
        ends = [e for _, _, e in tl.launched(a, b)]
        end = max(ends) - tl.offset(b) if ends else b
        ms += (max(end, b) - a) / 1e6
    return ms / len(draws)
