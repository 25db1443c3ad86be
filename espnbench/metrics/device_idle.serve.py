"""Share in % of the traced window in which no kernel, copy or fill ran on
the device (the profiler's timeline)."""
from espnbench.readers import idle_share


def read(record):
    return idle_share(record)
