"""Probe levels a drained batch takes: ``lane_probe_level.launches`` over
the window divided by the batches drained in it (program counter)."""


def read(ctx):
    launches = ctx["counters"].get("lane_probe_launches", 0)
    if not launches or not ctx["units"]:
        return None
    return launches / ctx["units"]
