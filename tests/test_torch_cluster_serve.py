"""Serving on the port's storage cluster against the JAX package's, on the
CPU, at 2,000 docs: the hedged-read primitive, ``RetrievalServer``'s
cluster counters (hedges, hedge bytes, arena-cache traffic, per-shard
device totals, all serve-window deltas), the feedback autoscaler on a
simulated clock and on a live cluster, and ``Pipeline.serve(autoscale=)``.

A server's batches are made deterministic by queueing every request before
the first dispatch (``max_batch`` requests, a long ``max_wait_s``), so the
cluster's counters are a function of the inputs and equal the reference's.
Every wait has a timeout and every server stops in a ``finally``.
"""
import argparse

import pytest

from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.pipeline import RetrievalConfig as RefRetrieval
from repro.pipeline import StorageConfig as RefStorage
from repro.pipeline.config import ClusterConfig as RefClusterConfig
from repro.serve import autoscaler as ref_autoscaler
from repro.serve.scheduler import BatchPolicy as RefBatchPolicy
from repro.serve.scheduler import hedged_read as ref_hedged_read
from repro.storage import cluster as ref_cluster
from _torch_parity import assert_same_ranking, index_arrays, layout_arrays
from repro_torch import convert
from repro_torch.pipeline import Pipeline, PipelineConfig
from repro_torch.pipeline.config import ClusterConfig
from repro_torch.serve import autoscaler
from repro_torch.serve.scheduler import BatchPolicy, hedged_read
from repro_torch.serve.slo import SLOPolicy
from repro_torch.storage import cluster

WAIT = 30.0
HOT = dict(n_shards=2, replication=2, replica_mults=[3.0, 1.0],
           hedge_quantile=0.9, arena_cache_mb=4.0)


@pytest.fixture(scope="module")
def env(small_corpus):
    cfg = RefConfig(storage=RefStorage(t_max=64, mem_budget_frac=1.0),
                    retrieval=RefRetrieval(mode="gds", nprobe=16,
                                           k_candidates=50,
                                           prefetch_step=0.3))
    cfg.index.ncells = 32
    base = RefPipeline.build(cfg, corpus=small_corpus)
    yield dict(base=base, corpus=small_corpus,
               index=convert.ivf_index_from_numpy(index_arrays(base.index),
                                                  "cpu"),
               layout=convert.layout_from_numpy(layout_arrays(base.layout)))
    base.close()


def pipes(env, **cluster_kw):
    """The reference's and the port's gds pipelines on one cluster
    config."""
    d = env["base"].cfg.to_dict()
    rcfg, pcfg = RefConfig.from_dict(d), PipelineConfig.from_dict(d)
    rcfg.cluster = RefClusterConfig(**cluster_kw)
    pcfg.cluster = ClusterConfig(**cluster_kw)
    ref = RefPipeline.from_artifacts(rcfg, index=env["base"].index,
                                     layout=env["base"].layout,
                                     corpus=env["corpus"])
    port = Pipeline.from_artifacts(pcfg, index=env["index"],
                                   layout=env["layout"],
                                   corpus=env["corpus"], device="cpu")
    return ref, port


def serve_all(pipe, policy, queries):
    """Queue every query before the first dispatch (one batch of
    ``policy.max_batch``), wait, shut down; the server and its requests."""
    srv = pipe.serve(policy)
    try:
        reqs = [srv.query_async(*q) for q in queries]
        for r in reqs:
            assert r.done.wait(WAIT)
            assert r.error is None
    finally:
        srv.shutdown()
    return srv, reqs


def corpus_queries(c, idx):
    return [(c.queries_cls[i], c.queries_bow[i], int(c.query_lens[i]))
            for i in idx]


CLUSTER_FIELDS = ("shards", "shard_blocks", "shard_sim_s", "hedged_reads",
                  "hedge_wins", "hedge_bytes", "arena_cache_hit_rate")


@pytest.mark.parametrize("t_primary,t_secondary", [
    (0.100, 0.002), (0.001, 0.001), (0.006, 0.100)])
def test_hedged_read_mitigates_straggler(t_primary, t_secondary):
    """The standalone hedged read: the data path runs once; the clock is
    the cluster's ``hedge_clock``, as in the reference."""
    for fn in (hedged_read, ref_hedged_read):
        draws = iter([t_primary, t_secondary])
        got = fn(lambda ids: "data", [1], hedge_after_s=0.005,
                 sampler=lambda: next(draws))
        if fn is hedged_read:
            want = got
        else:
            assert got == want
    assert want[0] == "data"
    assert want[2] == (t_primary > 0.005)
    if t_primary == 0.100:
        assert want[1] == pytest.approx(0.007)


@pytest.mark.parametrize("batches", [1, 2])
def test_serve_reports_cluster_stats(env, batches):
    """Hedged, cached cluster serving: shards, per-shard blocks, hedges,
    hedge bytes and the cache's hit rate in the server's summary equal
    the reference server's for the same batches (the second batch rides
    the cache), and the answers equal the reference's."""
    ref, port = pipes(env, **HOT)
    qs = corpus_queries(env["corpus"], [i % 4 for i in range(8)])
    try:
        got, want = [], []
        for _ in range(batches):
            got.append(serve_all(port, BatchPolicy(max_batch=8,
                                                   max_wait_s=5.0), qs))
            want.append(serve_all(ref, RefBatchPolicy(max_batch=8,
                                                      max_wait_s=5.0), qs))
        first = got[0][0].stats.summary()
        assert first["hedged_reads"] > 0 and first["hedge_bytes"] > 0
        for (srv, reqs), (rsrv, rreqs) in zip(got, want):
            s, rs = srv.stats.summary(), rsrv.stats.summary()
            assert s["shards"] == 2 and len(s["shard_blocks"]) == 2
            assert 0.0 <= s["arena_cache_hit_rate"] <= 1.0
            for k in CLUSTER_FIELDS:
                assert s[k] == rs[k], k
            assert s.get("mutation") == rs.get("mutation")
            assert srv.stats.cache_hits == rsrv.stats.cache_hits
            for r, w in zip(reqs, rreqs):
                assert_same_ranking(w.result, r.result)
        if batches == 2:
            assert got[1][0].stats.cache_hits > 0
    finally:
        ref.close(), port.close()


def test_serve_stats_are_serve_window_deltas(env):
    """Traffic served before the server starts (``pipe.search``) does not
    leak into the per-shard serve stats, as in the reference."""
    ref, port = pipes(env, n_shards=2)
    c = env["corpus"]
    try:
        for p in (ref, port):
            p.search(c.queries_cls[:6], c.queries_bow[:6], c.query_lens[:6])
        pre = [st["blocks"] for st in port.tier.per_shard_stats()]
        qs = corpus_queries(c, range(4))
        srv, _ = serve_all(port, BatchPolicy(max_batch=4, max_wait_s=5.0), qs)
        rsrv, _ = serve_all(ref, RefBatchPolicy(max_batch=4, max_wait_s=5.0),
                            qs)
        post = [st["blocks"] for st in port.tier.per_shard_stats()]
        assert srv.stats.summary()["shard_blocks"] == \
            [b - a for a, b in zip(pre, post)] == \
            rsrv.stats.summary()["shard_blocks"]
    finally:
        ref.close(), port.close()


# -- the autoscaler ----------------------------------------------------------

class FakeTier:
    def __init__(self):
        self.hedge_quantile = 0.9
        self.alive = [[True, False], [True, True]]
        self.log = []

    def replica_status(self):
        return [list(a) for a in self.alive]

    def recover_replica(self, s, r):
        self.alive[s][r] = True
        self.log.append(("recover", s, r))
        return {"bytes": 128, "seconds": 0.1}

    def kill_replica(self, s, r):
        self.alive[s][r] = False
        self.log.append(("kill", s, r))

    def set_hedge_quantile(self, q):
        self.hedge_quantile = q
        self.log.append(("hedge", q))


def drive(mod, tier, trace, **cfg_kw):
    """Feed one latency trace to an autoscaler on a simulated clock (2 s
    a step); its actions."""
    a = mod.Autoscaler(tier, mod.AutoscalerConfig(**cfg_kw))
    now = 0.0
    for lat, stage in trace:
        now += 2.0
        a.observe(lat)
        if stage:
            a.observe_stage(stage)
        a.maybe_step(now=now)
    return a


def test_autoscaler_converges_on_simulated_clock():
    """Recover the dead replica, tighten hedging to its floor, relax back
    to the initial quantile: the port's decisions are the reference's,
    action for action (evidence included)."""
    trace = ([(120.0, "critical_io")] * 120 + [(5.0, None)] * 100)
    kw = dict(slo_ms=50.0, window=16, min_fill=8, interval_s=1.0,
              patience=1)
    tier, rtier = FakeTier(), FakeTier()
    a = drive(autoscaler, tier, trace, **kw)
    r = drive(ref_autoscaler, rtier, trace, **kw)
    assert a.actions == r.actions and tier.log == rtier.log
    assert tier.alive[0][1]
    assert tier.hedge_quantile == pytest.approx(0.9)
    kinds = [x["action"] for x in a.actions]
    assert kinds[0] == "recover_replica"
    assert "tighten_hedge" in kinds and "relax_hedge" in kinds
    assert a.actions[0]["evidence"]["dominant"] == "critical_io"


def test_autoscaler_rate_limit_and_min_fill():
    for mod in (autoscaler, ref_autoscaler):
        a = mod.Autoscaler(FakeTier(), mod.AutoscalerConfig(
            slo_ms=50.0, window=16, min_fill=8, interval_s=1.0))
        for _ in range(4):
            a.observe(500.0)
        assert a.maybe_step(now=1.0) is None
        for _ in range(8):
            a.observe(500.0)
        assert a.maybe_step(now=2.0) is not None
        for _ in range(8):
            a.observe(500.0)
        assert a.maybe_step(now=2.5) is None


def test_autoscaler_scale_down_kills_a_surplus_replica():
    trace = [(5.0, None)] * 40
    kw = dict(slo_ms=50.0, window=8, min_fill=4, interval_s=1.0, patience=1,
              scale_down=True)
    tier, rtier = FakeTier(), FakeTier()
    a = drive(autoscaler, tier, trace, **kw)
    r = drive(ref_autoscaler, rtier, trace, **kw)
    assert a.actions == r.actions and tier.log == rtier.log
    assert ("kill", 1, 1) in tier.log


def test_autoscaler_fault_trigger_recovers_replica(env):
    """Injected-fault pressure past the trigger revives a dead replica of
    a live cluster, billing its re-sync as the reference's does."""
    kw = dict(n_shards=2, replication=2, t_max=64)
    clus = cluster.StorageCluster(env["layout"], device="cpu", **kw)
    rclus = ref_cluster.StorageCluster(env["base"].layout, **kw)
    acts = []
    for mod, c in ((autoscaler, clus), (ref_autoscaler, rclus)):
        c.kill_replica(0, 0)
        sc = mod.Autoscaler(c, mod.AutoscalerConfig(slo_ms=50.0,
                                                    fault_trigger=5))
        sc.observe_faults(3)
        assert sc.step(now=0.0) is None
        sc.observe_faults(4)
        act = sc.step(now=1.0)
        assert act is not None and act["action"] == "recover_replica"
        assert act["trigger"] == "faults"
        assert c.replica_status()[0][0]
        acts.append(act)
        c.kill_replica(0, 0)
        sc2 = mod.Autoscaler(c, mod.AutoscalerConfig(slo_ms=50.0,
                                                     fault_trigger=0))
        sc2.observe_faults(100)
        assert sc2.step(now=0.0) is None
    assert acts[0] == acts[1]
    assert clus.stats == rclus.stats
    clus.close(), rclus.close()


def test_pipeline_serve_attaches_the_autoscaler(env):
    """``cfg.serve.autoscale`` on a cluster under an SLO: the server
    carries an ``Autoscaler`` on the tier, fed every request (its window
    fills, its metrics are exposed) and decisions log with their time;
    without a cluster, or without an SLO, ``serve`` refuses, as the
    reference's does."""
    ref, port = pipes(env, **HOT)
    c = env["corpus"]
    try:
        port.cfg.serve.autoscale = True
        with pytest.raises(RuntimeError, match="needs an SLO"):
            port.serve()
        port.cfg.serve.slo_ms, port.cfg.serve.shed = 50.0, False
        port.cfg.serve.autoscale_interval_s = 0.0
        srv = port.serve()
        try:
            assert isinstance(srv.policy, SLOPolicy)
            sc = srv.autoscaler
            assert isinstance(sc, autoscaler.Autoscaler)
            assert sc.tier is port.tier and sc.cfg.slo_ms == 50.0
            reqs = [srv.query_async(*q)
                    for q in corpus_queries(c, range(16))]
            for r in reqs:
                assert r.done.wait(WAIT) and r.error is None
            assert len(sc.actions) + len(sc._lat) > 0
            for act in sc.actions:
                assert "t" in act and act["action"] in (
                    "tighten_hedge", "relax_hedge", "recover_replica")
            assert "autoscaler_p99_ms" in srv.metrics_text()
        finally:
            srv.shutdown()
    finally:
        ref.close(), port.close()
    cfg = PipelineConfig.from_dict(env["base"].cfg.to_dict())
    cfg.serve.autoscale, cfg.serve.slo_ms = True, 50.0
    with Pipeline.from_artifacts(cfg, index=env["index"],
                                 layout=env["layout"], device="cpu") as p:
        with pytest.raises(RuntimeError, match="requires the cluster tier"):
            p.serve()


def test_serve_config_dict_and_cli_round_trip():
    argv = ["--slo-ms", "35", "--shed-margin", "1.5", "--autoscale",
            "--autoscale-window", "48", "--autoscale-interval-s", "0.5",
            "--autoscale-fault-trigger", "3", "--shards", "2",
            "--replication", "2"]
    cfg = PipelineConfig.from_cli(
        PipelineConfig.add_cli_args(argparse.ArgumentParser()).parse_args(
            argv))
    ref = RefConfig.from_cli(
        RefConfig.add_cli_args(argparse.ArgumentParser()).parse_args(argv))
    assert cfg.serve.autoscale and cfg.serve.autoscale_window == 48
    assert cfg.serve.autoscale_fault_trigger == 3
    assert cfg.to_dict() == ref.to_dict()
    assert PipelineConfig.from_dict(cfg.to_dict()) == cfg
