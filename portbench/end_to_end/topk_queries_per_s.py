"""Top-k answers a second at the certified budget: every walk probed in
the window over the configuration's ``n_r``, over the window's time (host
clock, whole units).  A unit of fewer walks than ``n_r`` counts as that
share of a query."""


def read(ctx):
    cell = ctx["cell"]
    return cell.walks() / cell.b["n_r"] / ctx["elapsed"]
