"""The maxsim kernel's share of its bound: each call's least time (frozen
byte and operation counts at its shapes and valid tokens) over the
kernel's device time in the trace, in %."""
from espnbench.kernel_counts import maxsim_bound_s
from espnbench.readers import roofline


def _bound(k, lq, d, n_tok, elt):
    return maxsim_bound_s(k, lq, d, float(n_tok), elt)


def read(record):
    return roofline(record, "maxsim", "maxsim", _bound)
