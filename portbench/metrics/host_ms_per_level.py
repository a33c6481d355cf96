"""Host time a probe level costs the drain: over the traced batches, the
drain's wall time less the time some device interval ran inside it,
divided by the ``lane_probe`` launches the drains made (profiler)."""


def read(ctx):
    tr = ctx["trace"]
    drains = tr.spans("drain")
    levels = sum(1 for _, _, name, at in tr.kernels if "lane_probe" in name
                 and any(a <= at < b for a, b in drains))
    if not drains or not levels:
        return None
    wall = sum(b - a for a, b in drains) / 1e9
    busy = sum(tr.busy(a, b) for a, b in drains)
    return (wall - busy) / levels * 1e3
