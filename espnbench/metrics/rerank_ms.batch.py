"""Wall ms a batch of the ``rerank_query`` calls (the wait for their rows,
``gather_pack`` and ``maxsim`` included), synchronised at each exit."""
from espnbench.readers import ms_per_batch


def read(record):
    return ms_per_batch(record, "rerank")
