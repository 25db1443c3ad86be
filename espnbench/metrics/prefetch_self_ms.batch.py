"""Wall ms a batch of ``ANNPrefetcher.run_batch`` less its IVF search and
``read_batch`` calls: the hit masks, the reuse check, the list building."""
from espnbench.readers import ms_per_batch


def read(record):
    return ms_per_batch(record, "prefetch", self_only=True)
