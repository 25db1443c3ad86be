"""Request scheduling for the retrieval server: deadline-aware continuous
batching + hedged storage reads (straggler mitigation).

Batching policy: dispatch when either ``max_batch`` requests are queued or
the oldest request has exhausted its ``max_wait_s`` window (keeps p99 bounded
at low load while reaching the SSD's batch-throughput regime at high load —
the batch-threshold math of paper eq. 4 decides ``max_batch``; see
``repro_torch.serve.slo.eq4_max_batch``).

With a deadline-aware policy (``repro_torch.serve.slo.SLOPolicy``) the batcher
additionally:

* orders dispatch by earliest deadline first (EDF) instead of FIFO,
* dispatches early when the most urgent request's slack is about to burn
  (deadline minus predicted service time drops under a slack guard),
* sizes each batch from the observed queue depth (``dynamic_batch``),
  capped by ``max_batch`` (the eq. 4 threshold) and shrunk when the
  predicted batch service time no longer fits the tightest deadline,
* sheds requests at admission when the queue-depth/service-time forecast
  says they would miss their deadline anyway (``admission`` hook, see
  ``repro_torch.serve.slo.AdmissionController``) — shed requests complete
  immediately with ``shed=True`` and are never handed to the handler.

Hedged reads are implemented by the storage cluster
(``repro_torch.storage.cluster.StorageCluster``): every batch the scheduler
dispatches routes through the backend's tier, and when that tier is a
cluster, lagging shard reads are re-issued on a replica after the
``hedge_quantile`` delay; ``hedged_read`` below is the same primitive
(``hedge_clock``) exposed for standalone read paths.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Any, Callable


@dataclass
class Request:
    rid: int
    payload: Any
    arrival_s: float = field(default_factory=time.monotonic)
    deadline_s: float | None = None    # absolute monotonic deadline (no SLO
                                       # when None: FIFO traffic)
    tenant: str = "default"
    done: threading.Event = field(init=False, repr=False)
    result: Any = field(init=False, default=None)
    latency_s: float = field(init=False, default=0.0)
    sim_ms: float = field(init=False, default=0.0)   # device-clock share
    shed: bool = field(init=False, default=False)    # rejected at admission
    abandoned: bool = field(init=False, default=False)  # caller timed out
    dispatch_s: float = field(init=False, default=0.0)  # batch pickup time
    # per-stage latency attribution (ms), filled by the serving engine:
    # queue / critical_io / rerank / candidate_gen / other
    stage_ms: dict = field(init=False, default_factory=dict)
    fault_flags: dict = field(init=False, default_factory=dict)
    span: Any = field(init=False, default=None, repr=False)  # trace root
    error: BaseException | None = field(init=False, default=None)
    # ^ the backend raised while serving this request's batch: result is
    #   None, the exception is surfaced here, and the request is terminal
    #   (failed, never served/degraded)

    def __post_init__(self):
        self.done = threading.Event()

    @property
    def slo_budget_s(self) -> float | None:
        """The deadline budget this request arrived with (None = no SLO)."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - self.arrival_s


@dataclass
class BatchPolicy:
    """Static continuous-batching policy (FIFO, fixed batch cap)."""
    max_batch: int = 12           # ESPN batch threshold (paper eq. 4)
    max_wait_s: float = 0.004
    # deadline-aware knobs: inert on the static policy; SLOPolicy
    # (repro_torch.serve.slo) flips them on
    deadline_aware: bool = False  # EDF ordering + slack-aware early dispatch
    dynamic_batch: bool = False   # size batches from observed queue depth
    min_batch: int = 1            # dynamic sizing floor
    slack_frac: float = 0.25      # dispatch when slack < frac * SLO budget


class ServiceModel:
    """Decaying least-squares estimate of batch service time vs batch size.

    ``observe(batch, secs)`` feeds one handler invocation; ``predict(b)``
    returns the expected wall seconds for a batch of ``b`` as
    ``fixed + b * per_request`` (clamped non-negative). Used by the batcher
    for slack-aware dispatch / dynamic sizing and by the admission
    controller's wait forecast. Writes happen on the batcher loop; readers
    (submitting threads) tolerate torn reads — a stale forecast only shifts
    a shed decision by one batch.
    """

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self.n = 0
        self._b = self._s = self._bb = self._bs = 0.0

    def observe(self, batch: int, secs: float) -> None:
        a = self.alpha if self.n else 1.0
        self.n += 1
        self._b += a * (batch - self._b)
        self._s += a * (secs - self._s)
        self._bb += a * (batch * batch - self._bb)
        self._bs += a * (batch * secs - self._bs)

    def predict(self, batch: int) -> float:
        """Expected service seconds for one batch of ``batch`` requests."""
        if not self.n:
            return 0.0
        var = self._bb - self._b * self._b
        if var <= 1e-12:                 # only one batch size seen so far
            return self._s
        slope = max((self._bs - self._b * self._s) / var, 0.0)
        fixed = max(self._s - slope * self._b, 0.0)
        return fixed + slope * batch

    def predict_wait(self, depth: int, target: int) -> float:
        """Queueing delay for ``depth`` requests ahead of a newcomer when
        batches of ``target`` are dispatched back to back."""
        if not self.n or depth <= 0 or target <= 0:
            return 0.0
        return math.ceil(depth / target) * self.predict(target)


class ContinuousBatcher:
    """Collects requests into batches and runs `handler(list[Request])`."""

    def __init__(self, handler: Callable, policy: BatchPolicy, *,
                 on_complete: Callable[[Request], None] | None = None,
                 admission=None):
        self.handler = handler
        self.policy = policy
        self.on_complete = on_complete
        self.admission = admission       # .admit(req, depth, now) -> bool
        self.service = ServiceModel()
        self.queue: Queue = Queue()
        self._pending: list[Request] = []   # drained, not yet dispatched
        self._inflight = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.batches: list[int] = []
        self.errors = 0      # requests failed by a handler exception

    def start(self):
        self._thread.start()
        return self

    def depth(self) -> int:
        """Requests ahead of a newcomer: queued + drained + in flight."""
        return self.queue.qsize() + len(self._pending) + self._inflight

    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; returns False when admission control sheds it
        (``req.shed`` set, ``done`` fired, handler never sees it)."""
        if (self.admission is not None and req.deadline_s is not None
                and not self.admission.admit(req, self.depth(),
                                             time.monotonic())):
            req.shed = True
            req.done.set()
            return False
        self.queue.put(req)
        return True

    # -- collection ----------------------------------------------------------
    def _drain(self) -> None:
        """Move everything already queued into the pending buffer without
        blocking (a backlog must form full batches, not batches of one)."""
        while True:
            try:
                self._pending.append(self.queue.get_nowait())
            except Empty:
                return

    def _window_end(self, oldest_arrival_s: float, pickup_s: float) -> float:
        """Dispatch deadline for the current batch window.

        Clamped to ``min(arrival + max_wait, pickup + max_wait)``: the wait
        budget is measured from whichever is earlier, so a request that
        already aged in the queue before being picked up spends LESS of the
        window, never more.
        """
        return min(oldest_arrival_s, pickup_s) + self.policy.max_wait_s

    def _target_batch(self) -> int:
        """Dispatch size: the static cap, or (dynamic) the observed queue
        depth clamped to [min_batch, max_batch] and shrunk while the
        predicted service time overruns the tightest deadline's slack —
        queue depth asks for throughput, eq. 4's ``max_batch`` caps it, the
        SLO slack gets the veto."""
        pol = self.policy
        if not pol.dynamic_batch:
            return pol.max_batch
        depth = len(self._pending) + self.queue.qsize()
        t = max(pol.min_batch, min(pol.max_batch, depth))
        deadlines = [r.deadline_s for r in self._pending
                     if r.deadline_s is not None]
        if deadlines and self.service.n:
            slack = min(deadlines) - time.monotonic()
            while t > pol.min_batch and self.service.predict(t) > slack > 0:
                t -= 1
        return t

    def _urgency_deadline(self) -> float:
        """Absolute time at which the most urgent pending request's slack
        burns (dispatch must not wait past it). +inf when no deadlines."""
        pol = self.policy
        out = math.inf
        est = self.service.predict(max(len(self._pending), 1))
        for r in self._pending:
            if r.deadline_s is None:
                continue
            guard = pol.slack_frac * (r.deadline_s - r.arrival_s)
            out = min(out, r.deadline_s - est - guard)
        return out

    def _collect(self) -> list[Request]:
        pol = self.policy
        if not self._pending:
            try:
                self._pending.append(self.queue.get(timeout=0.05))
            except Empty:
                return []
        self._drain()
        pickup = time.monotonic()
        oldest = min(r.arrival_s for r in self._pending)
        window_end = self._window_end(oldest, pickup)
        while True:
            now = time.monotonic()
            if len(self._pending) >= self._target_batch():
                break
            until = window_end
            if pol.deadline_aware:
                until = min(until, self._urgency_deadline())
            if now >= until:
                break
            try:
                self._pending.append(self.queue.get(timeout=until - now))
            except Empty:
                break
            self._drain()
        if pol.deadline_aware:
            # EDF: tightest deadline first; FIFO among no-deadline traffic
            self._pending.sort(key=lambda r: (
                r.deadline_s if r.deadline_s is not None else math.inf,
                r.arrival_s))
        target = self._target_batch()
        batch, self._pending = self._pending[:target], self._pending[target:]
        live = [r for r in batch if not r.abandoned]
        for r in batch:                  # caller already raised: don't spend
            if r.abandoned:              # a batch slot on it
                r.done.set()
        return live

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            self._inflight = len(batch)
            self.batches.append(len(batch))
            t0 = time.monotonic()
            for r in batch:
                r.dispatch_s = t0      # queueing ends here: arrival -> t0
            try:
                self.handler(batch)
            except Exception as e:
                # a backend failure must not kill the dispatch loop: every
                # request in the batch fails terminally (error set, waiters
                # released below), later batches keep flowing
                self.errors += len(batch)
                for r in batch:
                    r.error = e
                    r.result = None
            self.service.observe(len(batch), time.monotonic() - t0)
            for r in batch:
                r.latency_s = time.monotonic() - r.arrival_s
                # observe BEFORE the event fires: a waiter released by
                # done.set() must find the request already recorded
                if self.on_complete is not None:
                    try:
                        self.on_complete(r)
                    except Exception:     # an observer must not kill the loop
                        pass
                r.done.set()
            self._inflight = 0

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def metrics_sources(self):
        """``(prefix, snapshot_fn)`` pairs for a ``MetricsRegistry``."""
        def snap() -> dict:
            n = len(self.batches)
            return {"queue_depth": self.depth(),
                    "batches_dispatched": n,
                    "requests_dispatched": sum(self.batches),
                    "errors": self.errors,
                    "mean_batch": round(sum(self.batches) / n, 4) if n
                    else 0.0,
                    "service_pred_ms":
                        round(self.service.predict(max(
                            self.policy.max_batch, 1)) * 1e3, 4)}
        return [("batcher", snap)]


def hedged_read(read_fn: Callable, ids, *, hedge_after_s: float,
                sampler: Callable[[], float]) -> tuple[Any, float, bool]:
    """Straggler mitigation for storage reads: model the device latency as a
    draw from `sampler`; if the first draw exceeds `hedge_after_s`, a
    duplicate request goes to a replica and the faster one wins.

    Returns (result, effective_latency_s, hedged?). The data path runs once
    (reads are idempotent); only the simulated clock differs. The clock math
    is the cluster's ``hedge_clock`` primitive, so standalone reads and
    sharded cluster reads hedge identically.
    """
    from repro_torch.storage.cluster import hedge_clock

    result = read_fn(ids)
    effective, hedged, _ = hedge_clock(sampler(), sampler, hedge_after_s)
    return result, effective, hedged
