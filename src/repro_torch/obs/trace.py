"""Dual-clock span tracing with Chrome/Perfetto trace-event export.

Every span carries BOTH clocks of the repo's convention: a **wall**
interval (``time.monotonic`` — queueing, host compute, thread scheduling)
and an optional **simulated device** duration ``sim_s`` (the SSD/accelerator
clock the cost models bill). Spans nest through a per-thread stack so one
query batch renders as a single tree: the serving engine opens ``request``/
``queue`` spans, the backend opens ``query_batch``/``candidate_gen``/
``read``/``rerank`` children, the storage tier adds ``plan``/``read_batch``/
``shard_read`` grandchildren with ``hedge``/``retry``/``repair``/
``failover`` leaves, and per-query attribution spans (``critical_io``,
``rerank``, ``hidden_io``, ``bit_filter``, ``degrade``) link back to the
originating request through ``qid``. Beside that tree, ``cat="host"`` spans
(wall time only) time the host work inside a batch: ``ivf_search``,
``hit_masks``, ``reuse_check``, ``views``, ``io_wait``, ``lookup``,
``score`` and ``bill``.

The tracer is only ever consulted when non-None — all hot paths guard with
``if tracer is not None`` so a default build takes the exact pre-existing
instruction stream (the bitwise-identity invariant).

``export()`` writes the Chrome trace-event JSON Perfetto loads directly:
wall spans on pid 1, and a parallel "device clock" track on pid 2 carrying
one event per span with nonzero ``sim_s`` (duration = simulated seconds).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    sid: int
    parent: int | None
    name: str
    cat: str = ""
    qid: object = None            # request id / batch query index, if any
    t0: float = 0.0               # wall, time.monotonic()
    t1: float | None = None       # None until closed
    sim_s: float = 0.0            # simulated device share of this span
    tid: int = 0
    args: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    @property
    def closed(self) -> bool:
        return self.t1 is not None


class Tracer:
    """Collects spans from every layer of one pipeline; thread-safe.

    ``begin``/``end`` maintain the per-thread parent stack; ``add`` records
    an already-measured interval (parented to the current stack top unless
    overridden) — the storage layers use it because their device clocks
    are computed, not awaited. Spans of ``cat="host"`` carry wall time
    alone: the host work inside a batch (the IVF search, hit masks, the
    reuse check, views, waits on staging, lookups, scoring, the bills),
    which ``obs.analyze.host_breakdown`` reads.
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._next_sid = 0
        self._open = 0
        self._local = threading.local()
        self._tids: dict[int, int] = {}
        self._sims: dict = {}        # qid -> {span name: summed sim_s}

    # -- internals -----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        t = self._tids.get(ident)
        if t is None:
            with self._lock:
                t = self._tids.setdefault(ident, len(self._tids) + 1)
        return t

    def _bill_sim(self, span: Span, sim_s: float) -> None:
        """Add ``sim_s`` to the span's query and name (under the lock)."""
        sims = self._sims.setdefault(span.qid, {})
        sims[span.name] = sims.get(span.name, 0.0) + sim_s

    def _register(self, span: Span, open_: bool) -> Span:
        with self._lock:
            span.sid = self._next_sid
            self._next_sid += 1
            self._spans.append(span)
            self._bill_sim(span, span.sim_s)
            if open_:
                self._open += 1
        return span

    # -- span lifecycle ------------------------------------------------------
    def begin(self, name: str, cat: str = "", qid=None, **args) -> Span:
        stack = self._stack()
        parent = stack[-1].sid if stack else None
        sp = Span(-1, parent, name, cat, qid, self.clock(), None, 0.0,
                  self._tid(), dict(args))
        self._register(sp, True)
        stack.append(sp)
        return sp

    def end(self, span: Span, sim_s: float | None = None, **args) -> Span:
        if span.t1 is not None:
            raise RuntimeError(f"span {span.name!r} (sid={span.sid}) "
                               "ended twice")
        span.t1 = self.clock()
        if sim_s is not None:
            span.sim_s = float(sim_s)
        if args:
            span.args.update(args)
        stack = self._stack()
        if span in stack:
            while stack and stack[-1] is not span:
                stack.pop()          # tolerate leaked children
            if stack:
                stack.pop()
        with self._lock:
            self._open -= 1
            self._bill_sim(span, span.sim_s)
        return span

    def add(self, name: str, cat: str = "", qid=None, t0: float | None = None,
            t1: float | None = None, sim_s: float = 0.0,
            parent: Span | None = None, **args) -> Span:
        """Record a completed span retroactively (never on the stack)."""
        now = self.clock()
        t0 = now if t0 is None else t0
        t1 = t0 if t1 is None else t1
        stack = self._stack()
        pid = parent.sid if parent is not None else (
            stack[-1].sid if stack else None)
        sp = Span(-1, pid, name, cat, qid, t0, t1, float(sim_s),
                  self._tid(), dict(args))
        return self._register(sp, False)

    def instant(self, name: str, cat: str = "", qid=None, **args) -> Span:
        return self.add(name, cat, qid, **args)

    # -- query stitching -----------------------------------------------------
    # The serving engine knows request ids; the backend only knows batch
    # indices. Before dispatching a batch it pushes the rid list here, the
    # backend adopts it at query_batch entry, and per-query spans resolve
    # ``query_key(b)`` to the request id (falling back to the index).
    def set_batch_qids(self, qids) -> None:
        self._local.pending_qids = list(qids)

    def adopt_batch_qids(self) -> None:
        self._local.qids = getattr(self._local, "pending_qids", None)
        self._local.pending_qids = None

    def query_key(self, b: int):
        qids = getattr(self._local, "qids", None)
        if qids is not None and b < len(qids):
            return qids[b]
        return b

    # -- inspection ----------------------------------------------------------
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def open_count(self) -> int:
        with self._lock:
            return self._open

    def query_sims(self, qid, names=None) -> dict[str, float]:
        """Sum ``sim_s`` per span name over spans tagged with ``qid`` (kept
        as the spans are recorded: one lookup, however many spans)."""
        with self._lock:
            sims = dict(self._sims.get(qid, {}))
        if names is None:
            return sims
        return {n: v for n, v in sims.items() if n in names}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._sims.clear()
            self._open = 0

    # -- export --------------------------------------------------------------
    def to_events(self) -> list[dict]:
        spans = self.spans()
        if not spans:
            return []
        base = min(s.t0 for s in spans)
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "wall clock"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "simulated device clock"}},
        ]
        for s in spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            args = dict(s.args)
            if s.qid is not None:
                args["qid"] = s.qid
            if s.sim_s:
                args["sim_ms"] = round(s.sim_s * 1e3, 6)
            args["sid"] = s.sid
            if s.parent is not None:
                args["parent_sid"] = s.parent
            ev = {"name": s.name, "cat": s.cat or "span", "ph": "X",
                  "ts": (s.t0 - base) * 1e6, "dur": (t1 - s.t0) * 1e6,
                  "pid": 1, "tid": s.tid, "args": args}
            events.append(ev)
            if s.sim_s > 0.0:
                events.append({"name": s.name, "cat": "device", "ph": "X",
                               "ts": (s.t0 - base) * 1e6,
                               "dur": s.sim_s * 1e6, "pid": 2, "tid": s.tid,
                               "args": args})
        return events

    def export(self, path: str) -> int:
        """Write Chrome/Perfetto trace-event JSON; returns event count."""
        events = self.to_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)

