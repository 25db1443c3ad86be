"""Constant-memory streaming metrics with Prometheus-style exposition.

``StreamingHistogram`` is the load-bearing type: a log-bucketed histogram
(bucket index = ``floor(log(x)/log(growth))``) that answers percentile
queries to a bounded relative error (growth 1.05 -> ~2.5%), merges with
other histograms, and — unlike the raw ``list.append`` ledgers it replaces
inside ``ServeStats`` — holds O(buckets) memory no matter how long the
serve runs. It keeps enough of the list API (``append``, ``extend``,
``len``, truthiness) that existing callers read naturally.

``MetricsRegistry`` holds owned counters/gauges/histograms *and* lazy
"sources": callables returning a ``{key: number}`` snapshot, registered by
the storage tiers / scheduler / autoscaler / caches. Sources cost nothing
on the hot path — they are only invoked at ``expose()`` time, which renders
everything in the Prometheus text format.
"""
from __future__ import annotations

import math
import re
import threading

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class StreamingHistogram:
    """Log-bucketed streaming histogram: bounded memory, mergeable,
    percentiles within ``growth - 1`` relative error.

    Non-positive samples (a zero wall latency is legal) land in a dedicated
    bucket and report as 0.0. Exact ``min``/``max``/``sum``/``count`` are
    tracked alongside the buckets so ``mean`` is exact and percentile
    answers are clamped into the observed range.
    """

    __slots__ = ("growth", "_inv_log", "buckets", "count", "total",
                 "nonpos", "_min", "_max")

    def __init__(self, growth: float = 1.05):
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.growth = growth
        self._inv_log = 1.0 / math.log(growth)
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.nonpos = 0          # samples <= 0 (kept out of the log buckets)
        self._min = math.inf
        self._max = -math.inf

    # -- ingestion -----------------------------------------------------------
    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x < self._min:
            self._min = x
        if x > self._max:
            self._max = x
        if x <= 0.0:
            self.nonpos += 1
            return
        b = math.floor(math.log(x) * self._inv_log)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    # list-API compatibility: the ServeStats ledgers used to be plain lists
    append = observe

    def extend(self, xs) -> None:
        for x in xs:
            self.observe(x)

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    # -- queries -------------------------------------------------------------
    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` in [0, 100]: the geometric midpoint of
        the bucket holding that rank, clamped to the exact observed range."""
        if not self.count:
            return 0.0
        rank = p / 100.0 * (self.count - 1)
        idx = int(math.floor(rank + 0.5))      # nearest-rank on the buckets
        if idx < self.nonpos:
            return max(0.0, self._min)
        seen = self.nonpos
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if idx < seen:
                rep = self.growth ** (b + 0.5)  # geometric bucket midpoint
                return min(max(rep, self._min), self._max)
        return self._max

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        if other.growth != self.growth:
            raise ValueError("cannot merge histograms with different growth")
        for b, n in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.count += other.count
        self.total += other.total
        self.nonpos += other.nonpos
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """``(upper_bound, cumulative_count)`` pairs for text exposition."""
        out = []
        cum = self.nonpos
        if self.nonpos:
            out.append((0.0, cum))
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            out.append((self.growth ** (b + 1), cum))
        return out

    def __repr__(self) -> str:
        return (f"StreamingHistogram(count={self.count}, "
                f"mean={self.mean():.4g}, buckets={len(self.buckets)})")


class MetricsRegistry:
    """Owned metrics plus pull-time sources, rendered as Prometheus text.

    ``register_source(prefix, fn)`` is the zero-overhead integration path:
    subsystems that already keep a stats dict (``StorageTier.stats``, the
    scheduler, the arena cache, ...) register a snapshot callable instead of
    instrumenting their hot paths; it runs only inside ``expose()``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._sources: list[tuple[str, object]] = []

    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help) if cls is not StreamingHistogram \
                    else cls()
                if cls is StreamingHistogram:
                    m.name, m.help = name, help  # type: ignore[attr-defined]
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> StreamingHistogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = StreamingHistogram()
                self._metrics[name] = m
            elif not isinstance(m, StreamingHistogram):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def register_source(self, prefix: str, fn) -> None:
        """``fn() -> dict[str, number]``, snapshotted at expose() time."""
        with self._lock:
            self._sources.append((prefix, fn))

    def register_sources(self, pairs) -> None:
        for prefix, fn in pairs:
            self.register_source(prefix, fn)

    # -- exposition ----------------------------------------------------------
    def expose(self) -> str:
        with self._lock:
            metrics = dict(self._metrics)
            sources = list(self._sources)
        lines: list[str] = []
        for name, m in sorted(metrics.items()):
            full = _metric_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full} {m.value}")
            else:
                lines.append(f"# TYPE {full} histogram")
                for ub, cum in m.cumulative_buckets():
                    lines.append(f'{full}_bucket{{le="{ub:g}"}} {cum}')
                lines.append(f'{full}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{full}_sum {m.total}")
                lines.append(f"{full}_count {m.count}")
        for prefix, fn in sources:
            try:
                snap = fn()
            except Exception:              # a dying source must not kill scrape
                continue
            for key, val in sorted(snap.items()):
                if isinstance(val, bool):
                    val = int(val)
                if not isinstance(val, (int, float)):
                    continue
                lines.append(f"{_metric_name(prefix + '_' + key)} {val}")
        return "\n".join(lines) + "\n" if lines else ""
