"""``lane_probe``'s share of its byte roofline over the traced batches:
the least bytes of each launch (``roofline.lane_probe_level_bytes`` at the
window's graph and lane width) over the peak bandwidth, divided by the
kernel's device time (profiler)."""

from portbench.roofline import lane_probe_level_bytes, share_pct


def read(ctx):
    ks = [(a, b) for a, b, name, _ in ctx["trace"].kernels if "lane_probe" in name]
    if not ks:
        return None
    f = ctx["facts"]
    per = lane_probe_level_bytes(live_slots=f["live_slots"], n=f["n"],
                                 sources=f["sources"], lanes=f["lanes"],
                                 itemsize=f["itemsize"])
    return share_pct(per * len(ks), sum(b - a for a, b in ks) / 1e9, ctx["peak_bw"])
