"""ESPN retrieval serving engine: continuous batching in front of a retrieval
backend, with per-request latency accounting that combines the real wall
clock (queueing, host work) and the simulated device clock (SSD +
accelerator).

SLO accounting (see ``repro_torch.serve.slo`` for the semantics): every request
may carry a deadline; its observed SLO latency is wall (queueing + host)
plus its simulated device share. Terminal states are disjoint — served in
SLO, violation, shed (admission control; never handed to the handler),
timeout (the caller abandoned; never recorded as served). The headline
metric is ``goodput_under_slo = served_in_slo / offered``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import MetricsRegistry, StreamingHistogram
from repro_torch.obs.analyze import dominant_stage
from repro_torch.serve.scheduler import BatchPolicy, ContinuousBatcher, Request

# live-mutation / failure-recovery counters mirrored from the storage
# cluster's stats dict into ServeStats (absent on an immutable tier)
_MUT_KEYS = ("ingests", "ingested_docs", "deletes", "tombstones",
             "compactions", "rebalances", "migration_bytes", "failovers",
             "replicas_killed", "replicas_recovered", "recovery_bytes")


@dataclass
class TenantStats:
    """Per-tenant SLO ledger (one per distinct ``Request.tenant``)."""
    offered: int = 0
    served: int = 0
    shed: int = 0
    violations: int = 0
    in_slo: int = 0
    degraded: int = 0                  # served from resident scores (faults)
    errors: int = 0                    # failed by a handler exception
    slo_latencies_ms: StreamingHistogram = field(
        default_factory=StreamingHistogram)

    def goodput_under_slo(self) -> float:
        return self.in_slo / self.offered if self.offered else 0.0

    def summary(self) -> dict:
        xs = self.slo_latencies_ms
        return {"offered": self.offered, "served": self.served,
                "shed": self.shed, "violations": self.violations,
                "degraded": self.degraded, "errors": self.errors,
                "goodput_under_slo": round(self.goodput_under_slo(), 4),
                "slo_p50_ms": round(xs.percentile(50), 3) if xs else 0.0,
                "slo_p99_ms": round(xs.percentile(99), 3) if xs else 0.0}


@dataclass
class ServeStats:
    """Streaming serving ledger.

    Latency/batch/hit-rate distributions are ``StreamingHistogram``s —
    log-bucketed, constant memory no matter how long the server runs —
    NOT unbounded sample lists; percentiles come from the buckets (~2.5%
    relative error). The histograms keep the list-ish ``append``/``len``
    API, so recording code is unchanged.
    """
    n_requests: int = 0
    latencies_ms: StreamingHistogram = field(
        default_factory=StreamingHistogram)
    sim_latencies_ms: StreamingHistogram = field(
        default_factory=StreamingHistogram)
    batch_sizes: StreamingHistogram = field(
        default_factory=StreamingHistogram)
    hit_rates: StreamingHistogram = field(default_factory=StreamingHistogram)
    # SLO ledger (zero / empty when no request carried a deadline):
    offered: int = 0                   # everything submitted, sheds included
    shed: int = 0                      # rejected at admission, never served
    timeouts: int = 0                  # callers that abandoned query()
    slo_violations: int = 0            # served, but past the deadline
    served_in_slo: int = 0             # the goodput numerator
    degraded: int = 0                  # answered from resident/candidate
                                       # scores after a failed storage read —
                                       # terminal state of its own, NEVER
                                       # counted in served_in_slo
    errors: int = 0                    # failed terminally (backend raised:
                                       # degrade disabled, retry exhaustion…)
    slo_latencies_ms: StreamingHistogram = field(   # wall + sim share
        default_factory=StreamingHistogram)
    tenants: dict = field(default_factory=dict)           # name -> TenantStats
    # storage-cluster counters (zero when serving a single StorageTier):
    hedged_reads: int = 0
    hedge_wins: int = 0
    hedge_bytes: int = 0               # duplicate bytes moved by hedges
    cache_hits: int = 0                # cross-batch arena-cache rows served
    cache_misses: int = 0
    shard_blocks: list = field(default_factory=list)   # per-shard device blocks
    shard_sim_s: list = field(default_factory=list)    # per-shard device time
    # live-mutation / failure-recovery counters (zero on an immutable tier):
    ingests: int = 0
    ingested_docs: int = 0
    deletes: int = 0
    tombstones: int = 0
    compactions: int = 0
    rebalances: int = 0
    migration_bytes: int = 0
    failovers: int = 0                 # dead-primary batches absorbed
    replicas_killed: int = 0
    replicas_recovered: int = 0
    recovery_bytes: int = 0            # replica re-sync traffic
    # fault-injection counters (zero without a FaultInjector on the tier;
    # accumulated from each batch's LatencyBreakdown deltas):
    retries: int = 0
    checksum_failures: int = 0
    repair_bytes: int = 0
    faults_injected: int = 0
    # storage footprint of the tier being served (captured at server start;
    # fixed_stride layouts report zero offset/length metadata):
    resident_bytes: int = 0            # host/device-resident tier bytes
    layout_mode: str = ""              # ragged | fixed_stride ("" = unknown)

    def tenant(self, name: str) -> TenantStats:
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = TenantStats()
        return t

    def goodput_under_slo(self) -> float:
        """Fraction of OFFERED load served within its SLO — sheds and
        timeouts count against it; a no-deadline request counts as in-SLO
        when served (its SLO is vacuous)."""
        return self.served_in_slo / self.offered if self.offered else 0.0

    def degraded_frac(self) -> float:
        """Fraction of offered load answered in degraded mode. Disjoint from
        goodput: a degraded answer is never served_in_slo."""
        return self.degraded / self.offered if self.offered else 0.0

    def percentile(self, p: float, sim: bool = True) -> float:
        xs = self.sim_latencies_ms if sim else self.latencies_ms
        return xs.percentile(p) if xs else 0.0

    def slo_percentile(self, p: float) -> float:
        xs = self.slo_latencies_ms
        return xs.percentile(p) if xs else 0.0

    def summary(self) -> dict:
        out = {
            "n": self.n_requests,
            "mean_ms": round(self.sim_latencies_ms.mean(), 2)
            if self.sim_latencies_ms else 0,
            "p50_ms": round(self.percentile(50), 2),
            "p99_ms": round(self.percentile(99), 2),
            # wall clock (queueing + host), distinct from the device clock
            "p50_wall_ms": round(self.percentile(50, sim=False), 2),
            "p99_wall_ms": round(self.percentile(99, sim=False), 2),
            "mean_batch": round(self.batch_sizes.mean(), 2)
            if self.batch_sizes else 0,
            "mean_hit_rate": round(self.hit_rates.mean(), 4)
            if self.hit_rates else None,
        }
        if self.slo_latencies_ms or self.shed or self.timeouts:
            out["slo"] = {
                "offered": self.offered,
                "served_in_slo": self.served_in_slo,
                "violations": self.slo_violations,
                "shed": self.shed,
                "timeouts": self.timeouts,
                "degraded": self.degraded,
                "errors": self.errors,
                "goodput_under_slo": round(self.goodput_under_slo(), 4),
                "degraded_frac": round(self.degraded_frac(), 4),
                "slo_p50_ms": round(self.slo_percentile(50), 3),
                "slo_p99_ms": round(self.slo_percentile(99), 3),
                "tenants": {name: t.summary()
                            for name, t in sorted(self.tenants.items())},
            }
        if self.shard_blocks:
            total = self.cache_hits + self.cache_misses
            out |= {
                "shards": len(self.shard_blocks),
                "shard_blocks": list(self.shard_blocks),
                "shard_sim_s": [round(x, 6) for x in self.shard_sim_s],
                "hedged_reads": self.hedged_reads,
                "hedge_wins": self.hedge_wins,
                "hedge_bytes": self.hedge_bytes,
                "arena_cache_hit_rate": round(self.cache_hits / total, 4)
                if total else 0.0,
            }
        mut = {"ingests": self.ingests, "ingested_docs": self.ingested_docs,
               "deletes": self.deletes, "tombstones": self.tombstones,
               "compactions": self.compactions,
               "rebalances": self.rebalances,
               "migration_bytes": self.migration_bytes,
               "failovers": self.failovers,
               "replicas_killed": self.replicas_killed,
               "replicas_recovered": self.replicas_recovered,
               "recovery_bytes": self.recovery_bytes}
        if any(mut.values()):
            out["mutation"] = mut
        flt = {"retries": self.retries,
               "checksum_failures": self.checksum_failures,
               "repair_bytes": self.repair_bytes,
               "faults_injected": self.faults_injected,
               "degraded": self.degraded, "errors": self.errors,
               "degraded_frac": round(self.degraded_frac(), 4)}
        if any(v for k, v in flt.items() if k != "degraded_frac"):
            out["faults"] = flt
        if self.layout_mode:
            out["storage"] = {"layout_mode": self.layout_mode,
                              "resident_bytes": self.resident_bytes}
        return out

    def expose(self, extra_sources=()) -> str:
        """Prometheus-style text exposition of the whole ledger.

        Histograms emit cumulative ``_bucket{le=...}`` lines; every scalar
        dataclass field becomes a ``serve_<field>`` sample. ``extra_sources``
        is an iterable of ``(prefix, snapshot_fn)`` pairs — what the storage
        tier / batcher / autoscaler ``metrics_sources()`` hooks return — so
        one call renders the full serving stack.
        """
        import dataclasses

        reg = MetricsRegistry()
        for name, h in (("serve_latency_wall_ms", self.latencies_ms),
                        ("serve_latency_sim_ms", self.sim_latencies_ms),
                        ("serve_latency_slo_ms", self.slo_latencies_ms),
                        ("serve_batch_size", self.batch_sizes),
                        ("serve_hit_rate", self.hit_rates)):
            reg.histogram(name).merge(h)

        def scalars() -> dict:
            out = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f.name] = v
            out["goodput_under_slo"] = round(self.goodput_under_slo(), 6)
            for i, (blk, sim) in enumerate(zip(self.shard_blocks,
                                               self.shard_sim_s)):
                out[f"shard_{i}_blocks"] = blk
                out[f"shard_{i}_sim_s"] = round(sim, 6)
            return out

        reg.register_source("serve", scalars)
        for name, t in sorted(self.tenants.items()):
            reg.register_source(f"tenant_{name}",
                                (lambda tt: lambda: {
                                    "offered": tt.offered,
                                    "served": tt.served,
                                    "shed": tt.shed,
                                    "violations": tt.violations,
                                    "in_slo": tt.in_slo,
                                    "degraded": tt.degraded,
                                    "errors": tt.errors})(t))
        reg.register_sources(extra_sources)
        return reg.expose()


class RetrievalServer:
    """Continuous batching in front of anything with ``query_batch`` — a
    ``repro_torch.pipeline`` RetrievalBackend.

    ``policy`` may be the static ``BatchPolicy`` or a deadline-aware
    ``repro_torch.serve.slo.SLOPolicy`` (EDF dispatch + admission control);
    ``autoscaler`` (``repro_torch.serve.autoscaler.Autoscaler``) is fed every
    completed request's SLO latency and stepped once per batch. The handler
    runs on the batcher's thread, so the backend's kernels
    launch from there, on that thread's current CUDA stream.
    """

    def __init__(self, retriever, *, policy: BatchPolicy | None = None,
                 autoscaler=None, tracer=None, trace_path: str | None = None):
        self.retriever = retriever
        self.policy = policy or BatchPolicy()
        self.autoscaler = autoscaler
        self.tracer = tracer
        self.trace_path = trace_path
        self.stats = ServeStats()
        tier = getattr(retriever, "tier", None)
        if tracer is not None:
            # propagate down the stack: backend spans (query_batch, rerank,
            # candidate_gen) and storage spans (plan, shard_read, faults)
            # land in the SAME tracer and stitch under the request spans
            retriever.attach_tracer(tracer)
        tier_stats = getattr(tier, "stats", {})
        self._mut_base = {k: tier_stats.get(k, 0) for k in _MUT_KEYS}
        if tier is not None and hasattr(tier, "memory_resident_bytes"):
            self.stats.resident_bytes = int(tier.memory_resident_bytes())
            self.stats.layout_mode = getattr(
                getattr(tier, "layout", None), "mode", "")
        # wall latency is recorded on the batcher loop when the request
        # completes, so async submitters (query_async) are measured too —
        # not just callers who block in query()
        self.batcher = ContinuousBatcher(self._handle, self.policy,
                                         on_complete=self._on_complete)
        if getattr(self.policy, "shed", False):
            from repro_torch.serve.slo import AdmissionController
            self.batcher.admission = AdmissionController(
                self.batcher.service, self.policy)
        self.batcher.start()
        self._rid = 0

    def _handle(self, batch: list[Request]):
        q_cls = np.stack([r.payload["cls"] for r in batch])
        q_bow = np.stack([r.payload["bow"] for r in batch])
        q_lens = np.array([r.payload["len"] for r in batch], np.int32)
        tier = getattr(self.retriever, "tier", None)
        before = ((dict(tier.stats), tier.per_shard_stats())
                  if tier is not None and "hedge_bytes" in getattr(
                      tier, "stats", {}) else None)
        tr = self.tracer
        if tr is not None:
            # per-query spans emitted inside query_batch carry the REQUEST
            # ids as qids, stitching backend/storage spans to request spans
            tr.set_batch_qids([r.rid for r in batch])
        resp = self.retriever.query_batch(q_cls, q_bow, q_lens)
        hedge_delta = {}
        if before is not None:
            hedge_delta = self._record_cluster(tier, *before)
        n = len(batch)
        bd = resp.breakdown
        per_query_sim = bd.total_s / n + bd.encode_s * (n - 1) / n
        flags = {"retries": int(getattr(bd, "retries", 0)),
                 "repairs": int(getattr(bd, "repair_bytes", 0) > 0
                                or getattr(bd, "checksum_failures", 0)),
                 "hedged": int(hedge_delta.get("hedged", 0)),
                 "hedge_wins": int(hedge_delta.get("hedge_wins", 0))}
        for r, ranked in zip(batch, resp.ranked):
            r.result = ranked
            r.sim_ms = per_query_sim * 1e3
            r.fault_flags = flags
            self.stats.sim_latencies_ms.append(per_query_sim * 1e3)
            # stage attribution: queueing is exact (arrival -> dispatch);
            # device stages come from this query's trace spans when tracing,
            # else from the batch breakdown split evenly
            queue_ms = max(r.dispatch_s - r.arrival_s, 0.0) * 1e3
            if tr is not None:
                sims = tr.query_sims(r.rid)
                cio_s = sims.get("critical_io", 0.0)
                rr_s = sims.get("rerank", 0.0) + sims.get("bit_filter", 0.0)
            else:
                cio_s = getattr(bd, "critical_io_s", 0.0) / n
                rr_s = getattr(bd, "rerank_s", 0.0) / n
            cand_s = getattr(bd, "ann_s", 0.0) / n
            other_s = max(per_query_sim - cio_s - rr_s - cand_s, 0.0)
            r.stage_ms = {"queue": round(queue_ms, 6),
                          "critical_io": round(cio_s * 1e3, 6),
                          "rerank": round(rr_s * 1e3, 6),
                          "candidate_gen": round(cand_s * 1e3, 6),
                          "other": round(other_s * 1e3, 6)}
        self.stats.batch_sizes.append(n)
        self.stats.hit_rates.append(bd.hit_rate)
        self.stats.n_requests += n
        for k in ("retries", "checksum_failures", "repair_bytes",
                  "faults_injected"):
            setattr(self.stats, k,
                    getattr(self.stats, k) + getattr(bd, k, 0))
        if self.autoscaler is not None:
            self.autoscaler.observe_faults(getattr(bd, "faults_injected", 0))

    def _on_complete(self, r: Request) -> None:
        """Batcher completion hook (runs before ``done`` fires). Abandoned
        requests are skipped entirely — the caller already raised
        TimeoutError and was counted there; recording its wall latency now
        would bill a request nobody is waiting for."""
        if r.abandoned:
            return
        s = self.stats
        t = s.tenant(r.tenant)
        tr = self.tracer
        if r.error is not None:
            # handler exception (degrade disabled + retry exhaustion, or a
            # genuine backend bug): terminal failure, never served
            s.errors += 1
            t.errors += 1
            if tr is not None:
                tr.add("request", cat="serve", qid=r.rid,
                       t0=r.arrival_s, t1=r.arrival_s + r.latency_s,
                       error=True, violation=False, tenant=r.tenant)
            return
        wall_ms = r.latency_s * 1e3
        s.latencies_ms.append(wall_ms)
        t.served += 1
        degraded = bool(getattr(r.result, "degraded", False))
        slo_ms = wall_ms + r.sim_ms        # device clock rides on top of wall
        violation = False
        budget_ms = None
        if degraded:
            # a degraded answer is its own terminal state: the caller got
            # SOMETHING (candidate-stage ranking), but it never counts as
            # served_in_slo and never as a violation either
            s.degraded += 1
            t.degraded += 1
        if r.deadline_s is not None:
            budget_ms = (r.deadline_s - r.arrival_s) * 1e3
            s.slo_latencies_ms.append(slo_ms)
            t.slo_latencies_ms.append(slo_ms)
            if degraded:
                pass
            elif slo_ms <= budget_ms:
                s.served_in_slo += 1
                t.in_slo += 1
            else:
                s.slo_violations += 1
                t.violations += 1
                violation = True
        elif not degraded:
            s.served_in_slo += 1           # no deadline: served is good
            t.in_slo += 1
        if violation and self.autoscaler is not None:
            # trace-driven tail diagnosis rides into the autoscaler's audit
            # log: the NEXT actuation cites these tallies as evidence
            self.autoscaler.observe_stage(
                dominant_stage(r.stage_ms, r.fault_flags))
        if tr is not None:
            end = r.arrival_s + r.latency_s
            root = tr.add(
                "request", cat="serve", qid=r.rid, t0=r.arrival_s, t1=end,
                sim_s=r.sim_ms * 1e-3, tenant=r.tenant, degraded=degraded,
                violation=violation, latency_ms=round(slo_ms, 6),
                budget_ms=round(budget_ms, 6) if budget_ms is not None
                else None,
                slo_ms=round(budget_ms, 6) if budget_ms is not None
                else None,
                stages_ms=dict(r.stage_ms), **r.fault_flags)
            r.span = root
            tr.add("queue", cat="serve", qid=r.rid, t0=r.arrival_s,
                   t1=min(max(r.dispatch_s, r.arrival_s), end),
                   parent=root)
        if self.autoscaler is not None:
            self.autoscaler.observe(slo_ms)
            self.autoscaler.maybe_step()

    def _record_cluster(self, tier, before: dict,
                        before_shards: list[dict]) -> dict:
        """Fold a storage-cluster batch's stat DELTAS into ServeStats:
        every counter here (hedge activity, arena-cache traffic, per-shard
        device totals) covers the serve window only, so the summary stays
        internally consistent even when the tier served traffic (e.g.
        ``pipe.search``) before the server started. Returns this batch's
        hedge delta (fed to per-request tail-diagnosis flags)."""
        s = self.stats
        after = tier.stats
        s.hedged_reads += after["hedged_reads"] - before["hedged_reads"]
        s.hedge_wins += after["hedge_wins"] - before["hedge_wins"]
        s.hedge_bytes += after["hedge_bytes"] - before["hedge_bytes"]
        s.cache_hits += after["cache_hits"] - before["cache_hits"]
        s.cache_misses += after["cache_misses"] - before["cache_misses"]
        # mutation/recovery counters measure from server start, not per
        # batch: recover/kill run BETWEEN batches (control-plane calls, not
        # queries), so windowed deltas would never see them. .get keeps
        # plain clusters at zero.
        for k in _MUT_KEYS:
            setattr(s, k, after.get(k, 0) - self._mut_base.get(k, 0))
        shards = tier.per_shard_stats()
        if len(s.shard_blocks) != len(shards):
            s.shard_blocks = [0] * len(shards)
            s.shard_sim_s = [0.0] * len(shards)
        for i, (st, st0) in enumerate(zip(shards, before_shards)):
            s.shard_blocks[i] += st["blocks"] - st0["blocks"]
            s.shard_sim_s[i] += st["sim_seconds"] - st0["sim_seconds"]
        return {"hedged": after["hedged_reads"] - before["hedged_reads"],
                "hedge_wins": after["hedge_wins"] - before["hedge_wins"]}

    # -- submission ----------------------------------------------------------
    def _submit(self, cls_vec, bow_vecs, q_len, tenant: str,
                slo_ms: float | None) -> Request:
        self._rid += 1
        if slo_ms is None:
            default = getattr(self.policy, "slo_ms", 0.0)
            slo_ms = default if default and default > 0 else None
        req = Request(self._rid, {"cls": cls_vec, "bow": bow_vecs,
                                  "len": q_len}, tenant=tenant)
        if slo_ms is not None:
            req.deadline_s = req.arrival_s + slo_ms / 1e3
        s = self.stats
        s.offered += 1
        t = s.tenant(tenant)
        t.offered += 1
        if not self.batcher.submit(req):
            s.shed += 1
            t.shed += 1
        return req

    def query(self, cls_vec, bow_vecs, q_len, timeout: float = 30.0, *,
              tenant: str = "default", slo_ms: float | None = None):
        req = self._submit(cls_vec, bow_vecs, q_len, tenant, slo_ms)
        if req.shed:
            raise ShedError(f"request {req.rid} shed by admission control")
        if not req.done.wait(timeout):
            # mark BEFORE counting: the batcher's completion hook skips
            # abandoned requests, so this caller is billed exactly once —
            # as a timeout here, never as a served wall latency later
            req.abandoned = True
            self.stats.timeouts += 1
            raise TimeoutError("query timed out")
        if req.error is not None:
            # the backend raised on the batcher's thread (a kernel error,
            # degrade disabled): the caller gets the exception itself
            raise req.error
        return req.result

    def query_async(self, cls_vec, bow_vecs, q_len, *,
                    tenant: str = "default",
                    slo_ms: float | None = None) -> Request:
        return self._submit(cls_vec, bow_vecs, q_len, tenant, slo_ms)

    # -- observability -------------------------------------------------------
    def metrics_sources(self) -> list:
        """Every ``(prefix, snapshot_fn)`` pair the serving stack exposes:
        the batcher, admission control, the autoscaler, and the storage
        tier underneath (cluster/shard/arena-cache sources)."""
        out = list(self.batcher.metrics_sources())
        if self.batcher.admission is not None \
                and hasattr(self.batcher.admission, "metrics_sources"):
            out += self.batcher.admission.metrics_sources()
        if self.autoscaler is not None \
                and hasattr(self.autoscaler, "metrics_sources"):
            out += self.autoscaler.metrics_sources()
        tier = getattr(self.retriever, "tier", None)
        if tier is not None and hasattr(tier, "metrics_sources"):
            out += tier.metrics_sources()
        return out

    def metrics_text(self) -> str:
        """Prometheus-style exposition of the full serving stack."""
        return self.stats.expose(self.metrics_sources())

    def export_trace(self, path: str) -> int:
        """Write the accumulated trace as Chrome/Perfetto trace-event JSON.
        Returns the event count; 0 when the server runs untraced."""
        if self.tracer is None:
            return 0
        return self.tracer.export(path)

    def shutdown(self):
        self.batcher.stop()
        if self.trace_path and self.tracer is not None:
            self.tracer.export(self.trace_path)


class ShedError(RuntimeError):
    """A blocking ``query()`` was rejected by admission control."""
