"""Share in % of the requested candidate bytes that batching read once for
several queries: dedup_bytes_saved / (bytes_read + dedup_bytes_saved)."""
from espnbench.readers import breakdowns


def read(record):
    bds = breakdowns(record)
    saved = sum(b.dedup_bytes_saved for b in bds)
    total = saved + sum(b.bytes_read for b in bds)
    return 100.0 * saved / total if total else None
