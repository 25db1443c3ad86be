"""SLO semantics for the serving stack.

Every request may carry a **deadline**: ``arrival + slo_ms``. Terminal
states, counted disjointly by ``ServeStats`` (repro_torch.serve.engine):

* **served in SLO** — completed with observed latency (wall queueing/host
  time plus the request's simulated device share) within its budget; the
  only state that counts toward goodput,
* **violation** — served, but past the budget,
* **shed** — rejected at admission because the queue-depth/service-time
  forecast predicted a miss; sheds complete immediately (``Request.shed``)
  and are never handed to the handler, so they cost no capacity and are
  never counted as served,
* **timeout** — the *caller* gave up waiting (``RetrievalServer.query``);
  the request is marked abandoned so late completion is not recorded.

``goodput_under_slo = served_in_slo / offered`` is the headline metric
(offered = everything submitted, sheds included).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.serve.scheduler import BatchPolicy, Request, ServiceModel


@dataclass
class SLOPolicy(BatchPolicy):
    """Deadline-aware continuous-batching policy: EDF dispatch, slack-aware
    early dispatch, queue-depth dynamic batch sizing (capped by the eq. 4
    ``max_batch`` threshold), and load-shedding admission control."""
    slo_ms: float = 50.0          # default deadline budget for requests
                                  # submitted without an explicit slo_ms
    deadline_aware: bool = True
    dynamic_batch: bool = True
    shed: bool = True             # attach an AdmissionController
    shed_margin: float = 1.0      # shed when margin * forecast > budget
                                  # (<1 = optimistic, >1 = conservative)


class AdmissionController:
    """Load shedding: reject a request whose completion forecast already
    misses its deadline. Forecast = queueing delay for the current depth
    (``ServiceModel.predict_wait``) plus one batch of service. Requests
    without a deadline are always admitted, and so is everything while the
    model has no samples (cold start: nothing to forecast from)."""

    def __init__(self, service: ServiceModel, policy: SLOPolicy):
        self.service = service
        self.policy = policy
        self.shed_count = 0
        self.admitted = 0

    def admit(self, req: Request, depth: int, now: float) -> bool:
        if req.deadline_s is None or not self.service.n:
            self.admitted += 1
            return True
        pol = self.policy
        target = max(pol.min_batch, min(pol.max_batch, max(depth, 1)))
        eta = (self.service.predict_wait(depth, target)
               + self.service.predict(target))
        if now + pol.shed_margin * eta > req.deadline_s:
            self.shed_count += 1
            return False
        self.admitted += 1
        return True

    def metrics_sources(self):
        """``(prefix, snapshot_fn)`` pairs for a ``MetricsRegistry``."""
        def snap() -> dict:
            total = self.admitted + self.shed_count
            return {"admitted": self.admitted, "shed": self.shed_count,
                    "shed_frac": round(self.shed_count / total, 6)
                    if total else 0.0}
        return [("admission", snap)]


def eq4_max_batch(prefetcher, nprobe: int, bytes_per_query: float, *,
                  lo: int = 1, hi: int = 64) -> int:
    """The paper's eq. 4 batch threshold as a dispatch cap: the batch size
    at which prefetch bandwidth stops hiding the per-query read traffic
    (``ANNPrefetcher.batch_threshold``), clamped to a sane dispatch range.
    Feed it to ``BatchPolicy.max_batch`` / ``SLOPolicy.max_batch``."""
    th = prefetcher.batch_threshold(nprobe, bytes_per_query)
    return int(min(max(round(th), lo), hi))
