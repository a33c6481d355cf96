"""Peaks of the card and the least bytes of each kernel's work.

Least bytes follow one rule: each input byte of the level read once and
each output byte written once, counting only what this level's own inputs
need (a table row that no live edge reads is not needed).  A share is the
least time (bytes over the peak bandwidth) divided by the device time the
trace gives the kernel, so it cannot pass 100 % unless the bytes are
counted too high or the time leaves out part of the work.
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB, published peaks (NVIDIA's data sheet) at the 700 W
# power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, hbm_bytes=80e9),
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def hbm_peak(kind: str) -> float:
    """Peak HBM bandwidth (B/s) of the card named ``kind``."""
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])["hbm_bytes_per_s"]


def lane_probe_level_bytes(*, live_slots: int, n: int, sources: int,
                           lanes: int, itemsize: int) -> int:
    """One fused lane-probe level over an ELL table.

    Inputs read once: the live slots (int32), ``row_len`` and the push
    weights (4 bytes a row each), and the rows of the ``[n + 1, W]`` score
    buffer that some live slot reads (``sources`` of them).  Output written
    once: the ``[n, W]`` scores of the next level.  The per-column deposit
    into the accumulator is left out (a per-query sum would need no
    ``[n, W]`` accumulator), as are the four ``[W]`` vectors."""
    return (4 * live_slots + 8 * n + itemsize * sources * lanes
            + itemsize * n * lanes)


def push_level_bytes(*, live_edges: int, n_pad: int, cols: int,
                     itemsize: int = 4) -> int:
    """One COO push level of the production step: the live edges
    (int32 source and destination) and the ``[n_pad, C]`` frontier read
    once, the ``[n_pad, C]`` result written once."""
    return 8 * live_edges + 2 * itemsize * n_pad * cols


def share_pct(least_bytes: float, seconds: float, peak: float) -> float | None:
    """Roofline share in %, or None when there is no time to divide by."""
    if seconds <= 0:
        return None
    return 100.0 * least_bytes / peak / seconds
