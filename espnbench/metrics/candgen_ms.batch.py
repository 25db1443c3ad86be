"""Wall ms a batch of the IVF search (``search_two_phase`` for espn,
``core/ivf.search`` for the other backends), synchronised at its exit."""
from espnbench.readers import ms_per_batch


def read(record):
    return ms_per_batch(record, "ivf_search")
