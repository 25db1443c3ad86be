"""Feedback autoscaler: sliding p99 vs the SLO drives hedge aggressiveness
and replica count.

The controller watches a sliding window of observed request latencies (wall
plus simulated device share, the same number ``ServeStats`` gates the SLO
on) and, once per ``interval_s``:

* **p99 > high x SLO** — scale up: first revive any dead replica
  (``recover_replica``, the failover plumbing: the re-sync bytes are
  billed by the cluster), else tighten the hedge quantile by ``hedge_step``
  (hedging earlier trades duplicate bytes for tail latency),
* **p99 < low x SLO for `patience` consecutive decisions** — relax: raise
  the hedge quantile back toward its initial value, then (only when
  ``scale_down`` is set) kill one surplus replica to free capacity,
* otherwise — hold.

Every actuation clears the window (the old distribution no longer describes
the system) and is appended to ``actions`` for audit. The controller is
clock-agnostic: pass ``now`` to ``step``/``maybe_step`` to run it on a
simulated clock (the bench and tests do), or omit it for wall time.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class AutoscalerConfig:
    slo_ms: float = 50.0
    window: int = 64               # sliding latency window (observations)
    min_fill: int = 8              # don't decide on fewer samples
    interval_s: float = 0.25       # minimum seconds between decisions
    high: float = 1.0              # act when p99 > high * slo_ms
    low: float = 0.4               # relax when p99 < low * slo_ms
    hedge_step: float = 0.05       # hedge-quantile delta per actuation
    hedge_floor: float = 0.5       # never hedge earlier than this quantile
    patience: int = 2              # calm decisions before relaxing
    scale_down: bool = False       # allow killing surplus replicas
    fault_trigger: int = 0         # injected-fault events per window that
                                   # force a scale-up (recover a dead replica
                                   # first) even while p99 looks healthy;
                                   # 0 disables the trigger entirely


@dataclass
class Autoscaler:
    """Drives a ``StorageCluster`` (or anything exposing ``hedge_quantile``,
    ``set_hedge_quantile``, ``replica_status``, ``kill_replica``,
    ``recover_replica``)."""
    tier: object
    cfg: AutoscalerConfig = field(default_factory=AutoscalerConfig)

    def __post_init__(self):
        self._lat: deque = deque(maxlen=self.cfg.window)
        self._last_step: float | None = None
        self._calm = 0
        self._hedge0 = float(getattr(self.tier, "hedge_quantile", 0.0))
        self._faults = 0         # injected-fault events since last actuation
        self._stages: dict = {}  # SLO-violation dominant-stage tallies
        self.actions: list[dict] = []

    # -- observations --------------------------------------------------------
    def observe(self, lat_ms: float) -> None:
        self._lat.append(float(lat_ms))

    def observe_faults(self, n: int) -> None:
        """Feed injected-fault events (a batch's ``faults_injected`` delta);
        a rising fault rate is a recovery trigger independent of p99."""
        self._faults += int(n)

    def observe_stage(self, stage: str) -> None:
        """Feed one SLO violation's dominant stage (trace-driven tail
        diagnosis, ``repro_torch.obs.analyze.dominant_stage``). The tallies
        ride on the next actuation's audit record as ``evidence`` — WHY the
        controller acted, not just what it did — and reset with it."""
        self._stages[stage] = self._stages.get(stage, 0) + 1

    def p99(self) -> float:
        return float(np.percentile(self._lat, 99)) if self._lat else 0.0

    # -- decisions -----------------------------------------------------------
    def maybe_step(self, now: float | None = None) -> dict | None:
        """Rate-limited ``step``: at most one decision per ``interval_s``."""
        now = time.monotonic() if now is None else now
        if (self._last_step is not None
                and now - self._last_step < self.cfg.interval_s):
            return None
        if len(self._lat) < self.cfg.min_fill:
            return None
        self._last_step = now
        return self.step(now)

    def step(self, now: float | None = None) -> dict | None:
        now = time.monotonic() if now is None else now
        cfg = self.cfg
        p99 = self.p99()
        act = None
        if cfg.fault_trigger and self._faults >= cfg.fault_trigger:
            # storage is faulting faster than the operator's tolerance:
            # treat it like an SLO breach (revive dead replicas first)
            self._calm = 0
            act = self._scale_up(p99)
            if act is not None:
                act["trigger"] = "faults"
                act["faults"] = self._faults
            self._faults = 0
        elif p99 > cfg.high * cfg.slo_ms:
            self._calm = 0
            act = self._scale_up(p99)
        elif p99 < cfg.low * cfg.slo_ms:
            self._calm += 1
            if self._calm >= cfg.patience:
                act = self._relax(p99)
                self._calm = 0
        else:
            self._calm = 0
        if act is not None:
            act["t"] = now
            if self._stages:
                by = dict(sorted(self._stages.items(),
                                 key=lambda kv: (-kv[1], kv[0])))
                act["evidence"] = {"violations_by_stage": by,
                                   "dominant": next(iter(by))}
                self._stages = {}
            self.actions.append(act)
            self._lat.clear()       # fresh window after actuation
        return act

    def metrics_sources(self):
        """``(prefix, snapshot_fn)`` pairs for a ``MetricsRegistry``."""
        def snap() -> dict:
            out = {"actions": len(self.actions),
                   "p99_ms": round(self.p99(), 4),
                   "window_fill": len(self._lat),
                   "hedge_quantile":
                       float(getattr(self.tier, "hedge_quantile", 0.0))}
            for stage, n in self._stages.items():
                out[f"violations_{stage}"] = n
            return out
        return [("autoscaler", snap)]

    # -- actuators -----------------------------------------------------------
    def _dead_replicas(self) -> list[tuple[int, int]]:
        status = self.tier.replica_status()
        return [(s, r) for s, reps in enumerate(status)
                for r, alive in enumerate(reps) if not alive]

    def _scale_up(self, p99: float) -> dict | None:
        dead = self._dead_replicas()
        if dead:
            s, r = dead[0]
            rec = self.tier.recover_replica(s, r) or {}
            return {"action": "recover_replica", "shard": s, "replica": r,
                    "recovery_bytes": rec.get("bytes", 0),
                    "p99_ms": round(p99, 3)}
        q = float(self.tier.hedge_quantile)
        if q > self.cfg.hedge_floor:
            q2 = max(self.cfg.hedge_floor, q - self.cfg.hedge_step)
            self.tier.set_hedge_quantile(q2)
            return {"action": "tighten_hedge", "hedge_quantile": round(q2, 4),
                    "p99_ms": round(p99, 3)}
        return None                    # saturated: nothing left to actuate

    def _relax(self, p99: float) -> dict | None:
        q = float(self.tier.hedge_quantile)
        if q < self._hedge0:
            q2 = min(self._hedge0, q + self.cfg.hedge_step)
            self.tier.set_hedge_quantile(q2)
            return {"action": "relax_hedge", "hedge_quantile": round(q2, 4),
                    "p99_ms": round(p99, 3)}
        if self.cfg.scale_down:
            # kill one replica of the shard with the most alive peers,
            # never the last one (the cluster refuses anyway)
            status = self.tier.replica_status()
            s = int(np.argmax([sum(reps) for reps in status]))
            if sum(status[s]) > 1:
                r = max(i for i, alive in enumerate(status[s]) if alive)
                self.tier.kill_replica(s, r)
                return {"action": "kill_replica", "shard": s, "replica": r,
                        "p99_ms": round(p99, 3)}
        return None
