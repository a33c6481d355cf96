"""Share of the traced window in which no device interval ran:
1 - (union of kernel, copy and set intervals) / window (profiler)."""


def read(ctx):
    lo, hi = ctx["window"]
    busy = ctx["trace"].busy(lo, hi)
    if hi <= lo or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ((hi - lo) / 1e9))
