"""The ivf_scan kernel's (centroid scores) share of its bound, in %."""
from espnbench.kernel_counts import ivf_scan_bound_s
from espnbench.readers import roofline


def read(record):
    return roofline(record, "ivf_scan", "ivf_scan", ivf_scan_bound_s)
