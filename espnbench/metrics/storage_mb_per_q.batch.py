"""Storage bytes billed a query (``LatencyBreakdown.bytes_read``), in MB."""
from espnbench.readers import breakdowns


def read(record):
    bds = breakdowns(record)
    n = sum(record["window"].batch_sizes[:len(bds)])
    if not bds or not n:
        return None
    return sum(b.bytes_read for b in bds) / n / 1e6
