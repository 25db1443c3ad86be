"""The prefetcher's hit rate in %, the mean of the window's batches'
``LatencyBreakdown.hit_rate`` (espn only)."""
from espnbench.readers import breakdowns, mode


def read(record):
    bds = breakdowns(record)
    if mode(record) != "espn" or not bds:
        return None
    return 100.0 * sum(b.hit_rate for b in bds) / len(bds)
