"""Open-loop production-traffic generator for the serving stack.

Closed-loop benches (fixed query lists replayed as fast as the server
drains them) can never overload the scheduler — arrivals stop when the
server slows down. This module generates **open-loop** traffic: arrival
times are drawn from a rate process up front and replayed on the wall
clock regardless of how the server is doing, which is what makes queueing,
shedding, and SLO violations observable at all.

Three pieces, all deterministic under a seed:

* **arrival processes** — ``poisson`` (constant rate), ``bursty``
  (duty-cycled on/off modulation: ``burst_factor`` x the base rate for
  ``burst_duty`` of every ``burst_period_s``, quiet otherwise, mean rate
  preserved), ``diurnal`` (sinusoidal envelope with period
  ``diurnal_period_s`` and trough ``diurnal_floor``, mean rate preserved).
  Sampling is Poisson thinning against the envelope.
* **query synthesis** — Zipf-skewed query-to-doc affinity over the *real*
  corpus embeddings (the benchmarks reuse their cached corpora): a target
  doc is drawn with popularity ∝ rank^-alpha, the query CLS is the doc's
  CLS plus noise and the query tokens are sampled from the doc's own BOW
  rows plus noise — head-doc skew the arena cache and prefetcher actually
  see.
* **multi-tenant mixes** — each ``TenantSpec`` contributes its own rate
  and SLO; arrivals are merged into one stream, tagged per tenant so
  ``ServeStats`` can report per-tenant percentiles and goodput.

``replay`` drives a ``RetrievalServer`` through ``query_async`` — it never
blocks on completion, so the queue really builds when the server falls
behind. Each completed request records both clocks: wall (queueing + host)
and the simulated device share.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class TenantSpec:
    name: str = "default"
    rate_qps: float = 100.0
    slo_ms: float = 50.0


@dataclass
class WorkloadConfig:
    duration_s: float = 2.0
    process: str = "poisson"         # poisson | bursty | diurnal
    rate_qps: float = 200.0          # aggregate rate when ``tenants`` empty
    slo_ms: float = 50.0             # deadline budget when ``tenants`` empty
    burst_factor: float = 4.0        # on-phase rate multiplier
    burst_duty: float = 0.25         # fraction of each period spent bursting
    burst_period_s: float = 0.5
    diurnal_period_s: float = 4.0
    diurnal_floor: float = 0.25      # trough rate as a fraction of the peak
    zipf_alpha: float = 1.1          # doc-popularity skew exponent
    query_noise: float = 0.25        # CLS perturbation away from the target
    token_noise: float = 0.08
    q_len: int = 24                  # tokens per generated query
    tenants: list[TenantSpec] = field(default_factory=list)
    seed: int = 0


@dataclass
class Arrival:
    t_s: float                       # offset from replay start
    tenant: str
    slo_ms: float
    query: int                       # row into the workload's query bank


@dataclass
class Workload:
    arrivals: list[Arrival]
    q_cls: np.ndarray                # (n, d_cls)
    q_bow: np.ndarray                # (n, q_len, d_bow)
    q_lens: np.ndarray               # (n,) int32
    target_docs: np.ndarray          # (n,) int64 — the Zipf-drawn affinities

    @property
    def n(self) -> int:
        return len(self.arrivals)

    def offered_qps(self) -> float:
        if not self.arrivals:
            return 0.0
        span = max(a.t_s for a in self.arrivals) or 1e-9
        return len(self.arrivals) / span


# -- arrival processes -------------------------------------------------------
def _envelope(cfg: WorkloadConfig, t: float) -> float:
    """Instantaneous rate multiplier at time ``t`` (time-average 1.0)."""
    if cfg.process == "poisson":
        return 1.0
    if cfg.process == "bursty":
        duty = min(max(cfg.burst_duty, 1e-6), 1.0)
        on = (t % cfg.burst_period_s) / cfg.burst_period_s < duty
        r_on = cfg.burst_factor
        # quiet-phase rate chosen so the duty-cycle average stays 1.0
        r_off = max((1.0 - r_on * duty) / (1.0 - duty), 0.0) \
            if duty < 1.0 else 1.0
        return r_on if on else r_off
    if cfg.process == "diurnal":
        f = min(max(cfg.diurnal_floor, 0.0), 1.0)
        raw = f + (1.0 - f) * 0.5 * (
            1.0 + math.sin(2.0 * math.pi * t / cfg.diurnal_period_s))
        return raw / (f + (1.0 - f) * 0.5)       # normalize the time average
    raise ValueError(f"unknown arrival process {cfg.process!r}; "
                     "expected poisson | bursty | diurnal")


def _peak(cfg: WorkloadConfig) -> float:
    if cfg.process == "bursty":
        return max(cfg.burst_factor, 1.0)
    if cfg.process == "diurnal":
        f = min(max(cfg.diurnal_floor, 0.0), 1.0)
        return 1.0 / (f + (1.0 - f) * 0.5)
    return 1.0


def arrival_times(cfg: WorkloadConfig, rate_qps: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Poisson thinning: draw a homogeneous process at the envelope peak,
    keep each point with probability envelope(t)/peak."""
    peak = rate_qps * _peak(cfg)
    if peak <= 0 or cfg.duration_s <= 0:
        return np.empty(0, np.float64)
    n_max = max(int(peak * cfg.duration_s * 1.5) + 16, 16)
    gaps = rng.exponential(1.0 / peak, size=n_max)
    ts = np.cumsum(gaps)
    while ts[-1] < cfg.duration_s:               # rare under-draw: extend
        more = np.cumsum(rng.exponential(1.0 / peak, size=n_max)) + ts[-1]
        ts = np.concatenate([ts, more])
    ts = ts[ts < cfg.duration_s]
    keep = rng.random(len(ts)) * _peak(cfg) < np.array(
        [_envelope(cfg, t) for t in ts])
    return ts[keep]


# -- query synthesis ---------------------------------------------------------
def affinity_queries(corpus, n: int, cfg: WorkloadConfig,
                     rng: np.random.Generator):
    """Zipf-skewed query bank over the real corpus embeddings. Returns
    ``(q_cls, q_bow, q_lens, target_docs)``; popularity rank is a seeded
    permutation of the doc-id space, so the hot set is stable per seed."""
    n_docs = corpus.n_docs
    order = rng.permutation(n_docs)              # rank -> doc id
    p = (np.arange(1, n_docs + 1, dtype=np.float64)) ** (-cfg.zipf_alpha)
    p /= p.sum()
    docs = order[rng.choice(n_docs, size=n, p=p)].astype(np.int64)

    d_cls = corpus.cls.shape[1]
    noise = rng.standard_normal((n, d_cls)).astype(np.float32)
    q_cls = corpus.cls[docs] + cfg.query_noise * noise
    q_cls /= np.maximum(np.linalg.norm(q_cls, axis=1, keepdims=True), 1e-9)

    d_bow = corpus.bow[0].shape[1] if corpus.bow else 0
    q_bow = np.zeros((n, cfg.q_len, d_bow), np.float32)
    q_lens = np.full(n, cfg.q_len, np.int32)
    for i, d in enumerate(docs):
        rows = corpus.bow[d]
        take = rng.integers(0, len(rows), cfg.q_len)
        toks = rows[take] + cfg.token_noise * rng.standard_normal(
            (cfg.q_len, d_bow)).astype(np.float32)
        q_bow[i] = toks / np.maximum(
            np.linalg.norm(toks, axis=1, keepdims=True), 1e-9)
    return q_cls, q_bow, q_lens, docs


def generate(cfg: WorkloadConfig, corpus) -> Workload:
    """Deterministic workload: same (cfg, corpus) -> identical arrivals and
    query vectors."""
    rng = np.random.default_rng(cfg.seed)
    tenants = cfg.tenants or [TenantSpec(rate_qps=cfg.rate_qps,
                                         slo_ms=cfg.slo_ms)]
    arrivals: list[Arrival] = []
    for spec in tenants:
        for t in arrival_times(cfg, spec.rate_qps, rng):
            arrivals.append(Arrival(float(t), spec.name, spec.slo_ms, 0))
    arrivals.sort(key=lambda a: a.t_s)
    q_cls, q_bow, q_lens, docs = affinity_queries(
        corpus, max(len(arrivals), 1), cfg, rng)
    for i, a in enumerate(arrivals):
        a.query = i
    return Workload(arrivals=arrivals, q_cls=q_cls, q_bow=q_bow,
                    q_lens=q_lens, target_docs=docs)


# -- replay ------------------------------------------------------------------
def replay(server, w: Workload, *, time_scale: float = 1.0) -> list:
    """Open-loop replay through ``server.query_async``: sleeps to each
    arrival offset (scaled by ``time_scale``) and submits without waiting
    for completions. Returns the submitted ``Request`` objects (shed ones
    included — their ``shed`` flag is already set)."""
    t0 = time.monotonic()
    out = []
    for a in w.arrivals:
        dt = a.t_s * time_scale - (time.monotonic() - t0)
        if dt > 0:
            time.sleep(dt)
        out.append(server.query_async(
            w.q_cls[a.query], w.q_bow[a.query], int(w.q_lens[a.query]),
            tenant=a.tenant, slo_ms=a.slo_ms))
    return out


def drain(requests, timeout_s: float = 60.0) -> int:
    """Wait for every request to complete (sheds already are). Returns how
    many finished in time."""
    end = time.monotonic() + timeout_s
    done = 0
    for r in requests:
        done += bool(r.done.wait(max(end - time.monotonic(), 0.0)))
    return done
