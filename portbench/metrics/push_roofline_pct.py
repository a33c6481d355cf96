"""The production push's share of its byte roofline over the traced step:
the least bytes of each push level (``roofline.push_level_bytes``: live
edges, frontier in, frontier out) over the peak bandwidth, divided by the
device time of every device interval launched inside a push call
(profiler; the ``spmm_csr`` kernel over each block's in-CSR today,
whatever replaces it)."""

from portbench.roofline import push_level_bytes, share_pct

SPANS = {"push": "repro_torch.core.distributed:coo_push"}


def read(ctx):
    tr = ctx["trace"]
    pushes = sorted(tr.spans("push"))
    if not pushes:
        return None
    starts = [a for a, _ in pushes]
    import bisect

    dev = 0
    for a, b, _, at in tr.kernels:
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at < pushes[i][1]:
            dev += b - a
    if not dev:
        return None
    f = ctx["facts"]
    per = push_level_bytes(live_edges=f["live_edges"], n_pad=f["n_pad"],
                           cols=f["cols"], itemsize=f["itemsize"])
    return share_pct(per * len(pushes), dev / 1e9, ctx["peak_bw"])
