"""Helpers the per-layer metric readers share. A reader takes the traced
run's record (``probe``: the wrapped calls' spans and kernel calls,
``trace``: the profiler's reading, ``window``, ``traffic``, ``config``,
``flops``) and returns a number, or None when the run holds nothing to
read."""
from __future__ import annotations

from espnbench.kernel_counts import FP16_TC_FLOPS_S
from espnbench.probe import kernel_seconds


def batches(record) -> int:
    return len(record["probe"].spans.get("query_batch", ()))


def ms_per_batch(record, span: str, self_only: bool = False):
    n = batches(record)
    p = record["probe"]
    if not n or span not in p.spans:
        return None
    return 1e3 * (p.self_time(span) if self_only else p.total(span)) / n


def mode(record) -> str:
    return record["config"]["pipeline"]["retrieval"]["mode"]


def breakdowns(record) -> list:
    return [r.breakdown for r in record["probe"].outputs.get("query_batch",
                                                             ())]


def idle_share(record):
    t = record["trace"]
    if not t or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(record, kernel: str, pattern: str, bound_of):
    """Share of the bound: the calls' least time over the kernels' device
    time in the trace."""
    calls = record["probe"].calls.get(kernel, ())
    dev_s = kernel_seconds(record["trace"], pattern)
    if not calls or dev_s <= 0:
        return None
    return 100.0 * sum(bound_of(*c) for c in calls) / dev_s


def mfu(record):
    t = record["trace"]
    if not t or t.get("window_s", 0) <= 0 or not record.get("flops"):
        return None
    return 100.0 * record["flops"] / (t["window_s"] * FP16_TC_FLOPS_S)
