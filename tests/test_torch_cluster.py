"""The port's sharded, replicated storage cluster against the JAX package's,
on the CPU, at 2,000 docs.

Both packages run on the same numpy artifacts: the reference builds the
index, the layout and the resident tables, and ``repro_torch.convert``
carries them across. The cluster's clock, hedges, failovers, arena cache
and fault draws are numpy functions of the same inputs in both packages, so
every bill and counter must be equal; ids are equal up to adjacent near-tie
swaps (``_torch_parity.assert_same_ranking``), scores within 1e-5. Within
the port, a cluster must rank and bill as the single tier does, bit for bit
(only the clock moves when the layout is sharded).
"""
import argparse
import dataclasses
import threading
from concurrent.futures import CancelledError

import numpy as np
import pytest

from _torch_parity import (assert_same_ranking, index_arrays, layout_arrays,
                           port_tables)
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.pipeline import RetrievalConfig as RefRetrieval
from repro.pipeline import StorageConfig as RefStorage
from repro.pipeline.config import ClusterConfig as RefClusterConfig
from repro.storage import cluster as ref_cluster
from repro.storage.arena_cache import ArenaCache as RefArenaCache
from repro.storage.faults import FaultConfig as RefFaultConfig
from repro.storage.faults import FaultInjector as RefFaultInjector
from repro.storage.faults import ShardReadError as RefShardReadError
from repro.storage.io_engine import StorageTier as RefTier
from repro.storage.layout import pack as ref_pack
from repro.storage.layout import unpack_doc as ref_unpack
from repro_torch import convert
from repro_torch.core.rerank import pack_tiles
from repro_torch.pipeline import (Pipeline, PipelineConfig, available_backends,
                                  get_backend)
from repro_torch.pipeline.config import ClusterConfig
from repro_torch.storage import cluster
from repro_torch.storage.arena_cache import ArenaCache
from repro_torch.storage.faults import (FaultConfig, FaultInjector,
                                        ShardReadError, verify_checksums)
from repro_torch.storage.io_engine import StorageTier
from repro_torch.storage.layout import unpack_doc

MODES = sorted(available_backends())
#: the reference's full scale-out stack (tests/test_cluster.py)
SCALE_OUT = dict(n_shards=2, replication=2, replica_mults=[3.0, 1.0],
                 hedge_quantile=0.9, jitter_sigma=0.2, arena_cache_mb=4.0)


def mini(n=60, d_cls=16, d_bow=8, seed=3, checksum=False):
    """The reference's ``_mini_layout`` and the port's copy of it."""
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((n, d_cls)).astype(np.float32)
    bow = [rng.standard_normal((int(t), d_bow)).astype(np.float32)
           for t in rng.integers(4, 40, n)]
    ref = ref_pack(cls, bow, dtype=np.float16, checksum=checksum)
    port = convert.layout_from_numpy(layout_arrays(ref))
    if checksum:
        port.checksums = ref.checksums.copy()
    return ref, port


def port_rows(res, rows=None):
    """Each arena row's token rows, decoded to fp32 from the port's arena
    (landed first)."""
    res.wait_all()
    rows = np.arange(res.plan.n_unique) if rows is None else rows
    tiles, lens = pack_tiles(res.arena, rows)
    t, n = tiles.float().numpy(), lens.numpy()
    return [t[i, :n[i]] for i in range(len(rows))]


def read_rows(read):
    tiles, lens = pack_tiles(read.arena, np.arange(len(read.arena.lens)))
    t, n = tiles.float().numpy(), lens.numpy()
    return [t[i, :n[i]] for i in range(len(n))]


def ref_rows(res, rows=None):
    res.wait_all()
    _, bow, lens = res.arena
    rows = np.arange(len(lens)) if rows is None else rows
    return [bow[i, :lens[i]] for i in rows]


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class Env:
    """The reference's 2,000-doc espn pipeline (tests/test_cluster.py's
    ``base``), its other modes, and the port's copies of the artifacts."""

    def __init__(self, corpus):
        cfg = RefConfig(
            storage=RefStorage(t_max=64, mem_budget_frac=1.0),
            retrieval=RefRetrieval(mode="espn", nprobe=16, k_candidates=50,
                                   prefetch_step=0.3, bit_filter=16))
        cfg.index.ncells = 32
        self.base = RefPipeline.build(cfg, corpus=corpus)
        self.corpus = corpus
        self.index = convert.ivf_index_from_numpy(
            index_arrays(self.base.index), "cpu")
        self.layout = convert.layout_from_numpy(
            layout_arrays(self.base.layout))
        self._refs = {"espn": self.base}
        self._tables = {}

    def ref(self, mode):
        if mode not in self._refs:
            self._refs[mode] = self.base.with_mode(mode)
        return self._refs[mode]

    def tables(self, mode):
        if mode not in self._tables:
            self._tables[mode] = port_tables(self.ref(mode))
        return self._tables[mode]

    def ref_pipe(self, mode, **cluster):
        cfg = RefConfig.from_dict(self.ref(mode).cfg.to_dict())
        cfg.cluster = RefClusterConfig(**cluster)
        return RefPipeline.from_artifacts(cfg, index=self.base.index,
                                          layout=self.base.layout,
                                          corpus=self.corpus)

    def port_pipe(self, mode, **cluster):
        cfg = PipelineConfig.from_dict(self.ref(mode).cfg.to_dict())
        cfg.cluster = ClusterConfig(**cluster)
        return Pipeline.from_artifacts(cfg, index=self.index,
                                       layout=self.layout, device="cpu",
                                       **self.tables(mode))

    def close(self):
        for p in self._refs.values():
            p.close()


@pytest.fixture(scope="module")
def env(small_corpus):
    e = Env(small_corpus)
    yield e
    e.close()


def dup_queries(corpus, n_base=5, reps=3):
    return (np.tile(corpus.queries_cls[:n_base], (reps, 1)),
            np.tile(corpus.queries_bow[:n_base], (reps, 1, 1)),
            np.tile(corpus.query_lens[:n_base], reps))


def assert_bitwise(a, b):
    """Two port responses: ids, scores, byte bills and the bill equal."""
    for x, y in zip(a.ranked, b.ranked):
        np.testing.assert_array_equal(y.doc_ids, x.doc_ids)
        np.testing.assert_array_equal(y.scores, x.scores)
        assert y.bow_bytes_read == x.bow_bytes_read


def assert_parity(ref_resp, port_resp):
    """Reference vs port: the same rankings (near ties aside), per-query
    bills and the whole breakdown."""
    assert len(ref_resp.ranked) == len(port_resp.ranked)
    for x, y in zip(ref_resp.ranked, port_resp.ranked):
        assert (y.n_reranked, y.bow_bytes_read, y.degraded) == (
            x.n_reranked, x.bow_bytes_read, x.degraded)
        assert_same_ranking(x, y)
    assert port_resp.breakdown.as_dict() == ref_resp.breakdown.as_dict()


def assert_same_counters(ref_tier, port_tier):
    assert port_tier.stats == ref_tier.stats
    assert port_tier.per_shard_stats() == ref_tier.per_shard_stats()
    assert port_tier.arena_cache.stats() == ref_tier.arena_cache.stats()


# -- partitioning ------------------------------------------------------------

@pytest.mark.parametrize("n,n_shards,partition", [
    (60, 3, "round_robin"), (60, 3, "range"), (200, 4, "range")])
def test_shard_layout_roundtrip(n, n_shards, partition):
    """The doc -> shard map and every shard's sub-layout (blob, offsets,
    token counts) equal the reference's; each shard's docs decode to the
    parent's; block mass is conserved; ranges are contiguous."""
    ref, port = mini(n=n)
    want = ref_cluster.shard_assignments(ref, n_shards, partition)
    got = cluster.shard_assignments(port, n_shards, partition)
    np.testing.assert_array_equal(got, want)
    total = 0
    for s in range(n_shards):
        gids = np.flatnonzero(got == s)
        sub = cluster.build_shard_layout(port, gids)
        rsub = ref_cluster.build_shard_layout(ref, gids)
        np.testing.assert_array_equal(sub.blob, rsub.blob)
        np.testing.assert_array_equal(sub.offsets, rsub.offsets)
        np.testing.assert_array_equal(sub.n_tokens, rsub.n_tokens)
        total += int(sub.offsets[:, 1].sum())
        for j, g in enumerate(gids):
            c, b = unpack_doc(sub, j)
            c_ref, b_ref = ref_unpack(ref, int(g))
            np.testing.assert_array_equal(c, c_ref)
            np.testing.assert_array_equal(b, b_ref)
    assert total == int(port.offsets[:, 1].sum())
    if partition == "range":
        assert (np.diff(got) >= 0).all()
        masses = [int(port.offsets[got == s, 1].sum())
                  for s in range(n_shards)]
        assert max(masses) <= 2 * min(masses)


def test_bad_partition_and_mults_rejected():
    _, layout = mini(n=10)
    with pytest.raises(ValueError):
        cluster.shard_assignments(layout, 2, "hash")
    with pytest.raises(ValueError):
        cluster.StorageCluster(layout, replication=2,
                               replica_mults=[1.0, 1.0, 1.0], device="cpu")
    with pytest.raises(ValueError):
        cluster.StorageCluster(layout, hedge_quantile=1.5, device="cpu")


# -- single-tier identity ----------------------------------------------------

def test_trivial_cluster_matches_tier_bitwise():
    """n_shards=1, replication=1, cache off: the port's cluster IS its
    tier (clock, blocks, attribution, rows, the empty-read floor, the
    serial path, the counters), and both bill as the reference's."""
    ref, layout = mini()
    tier = StorageTier(layout, stack="espn", t_max=48, device="cpu")
    clus = cluster.StorageCluster(layout, t_max=48, device="cpu")
    rclus = ref_cluster.StorageCluster(ref, t_max=48)
    lists = [np.array([3, 8, 8, 1]), np.array([8, 3]), np.array([], np.int64)]
    bt, bc, br = (x.read_batch(lists) for x in (tier, clus, rclus))
    assert bc.sim_seconds == bt.sim_seconds == br.sim_seconds
    assert bc.n_blocks == bt.n_blocks == br.n_blocks
    assert_rows_equal(port_rows(bc), ref_rows(br))
    assert_rows_equal(port_rows(bt), ref_rows(br))
    for b in range(len(lists)):
        assert bc.io_s(b) == bt.io_s(b) == br.io_s(b)
        assert bc.view(b)[1] == bt.view(b)[1] == br.view(b)[1]
    rt, rc, rr = (x.read([5, 5, 9]) for x in (tier, clus, rclus))
    assert rc.sim_seconds == rt.sim_seconds == rr.sim_seconds
    assert rc.n_blocks == rt.n_blocks == rr.n_blocks
    assert_rows_equal(read_rows(rc), [rr.bow[i, :rr.lens[i]]
                                      for i in range(3)])
    assert clus.read([]).sim_seconds == tier.read([]).sim_seconds \
        == rclus.read([]).sim_seconds
    st, sc, sr = (x.read_batch(lists[:2], coalesce=False)
                  for x in (tier, clus, rclus))
    assert sc.sim_seconds == st.sim_seconds == sr.sim_seconds
    assert sc.n_blocks == st.n_blocks == sr.n_blocks
    for k in ("docs", "doc_requests", "blocks", "sim_seconds"):
        assert clus.stats[k] == tier.stats[k]
    assert clus.stats == rclus.stats
    tier.close(), clus.close(), rclus.close()


@pytest.mark.parametrize("mode", MODES)
def test_trivial_cluster_identity_per_backend(env, mode):
    """Every registered backend on a trivial cluster (built directly, as
    the pipeline builds a plain tier for the default cluster config) ranks
    and bills as the port's single tier, bit for bit, and as the
    reference's trivial cluster."""
    ref = env.ref(mode)
    q = dup_queries(env.corpus)
    with env.port_pipe(mode) as tier_pipe:
        a = tier_pipe.search(*q)
        bcls = get_backend(mode)
        budget = (int(env.layout.nbytes * tier_pipe.cfg.storage
                      .mem_budget_frac) if bcls.needs_mem_budget else None)
        tables = env.tables(mode)
        clus = cluster.StorageCluster(
            env.layout, stack=bcls.storage_stack, mem_budget_bytes=budget,
            t_max=64, device="cpu", bits=tables.get("bits"),
            fde=tables.get("fde"))
        backend = bcls(env.index, clus,
                       tier_pipe.cfg.retrieval.to_espn_config(),
                       cost_model=tier_pipe.backend.cost,
                       compute=tier_pipe.backend.compute)
        b = backend.query_batch(*q)
    rclus = ref_cluster.StorageCluster(
        ref.layout, stack=bcls.storage_stack, mem_budget_bytes=budget,
        t_max=64, bits=ref.tier.bits, fde=ref.tier.fde)
    rbackend = type(ref.backend)(ref.index, rclus,
                                 ref.cfg.retrieval.to_espn_config(),
                                 cost_model=ref.backend.cost,
                                 compute=ref.backend.compute)
    r = rbackend.query_batch(*q)
    assert len(b.ranked) == len(q[0])
    assert_bitwise(a, b)
    assert b.breakdown.as_dict() == a.breakdown.as_dict()
    assert b.breakdown.hedge_bytes_read == 0
    assert_parity(r, b)
    assert clus.stats == rclus.stats
    clus.close(), rclus.close()


@pytest.mark.parametrize("mode", MODES)
def test_sharded_rankings_and_bills_identical(env, mode):
    """Three shards redistribute blocks: the port's rankings, scores and
    byte bills equal its single tier's bit for bit (only the clock moves),
    and the whole breakdown and every counter equal the reference's
    sharded run."""
    q = dup_queries(env.corpus)
    with env.port_pipe(mode) as tier_pipe, \
            env.port_pipe(mode, n_shards=3) as pipe, \
            env.ref_pipe(mode, n_shards=3) as ref:
        assert isinstance(pipe.tier, cluster.StorageCluster)
        a, b, r = tier_pipe.search(*q), pipe.search(*q), ref.search(*q)
        assert_bitwise(a, b)
        assert b.breakdown.bytes_read == a.breakdown.bytes_read
        assert b.breakdown.dedup_bytes_saved == a.breakdown.dedup_bytes_saved
        assert_parity(r, b)
        assert_same_counters(ref.tier, pipe.tier)


@pytest.mark.parametrize("mode", MODES)
def test_cluster_accounting_invariants(env, mode):
    """The full scale-out stack (2 shards x 2 replicas, a 3x degraded
    primary, hedging at the 0.9 quantile, jitter, a 4 MB arena cache), two
    passes (the second rides the cache): each pass's breakdown equals the
    reference's and keeps the accounting contract; hedges, hedge bytes,
    cache hits/misses/evictions and per-shard counters equal the
    reference's."""
    c = env.corpus
    q = (c.queries_cls[:6], c.queries_bow[:6], c.query_lens[:6])
    with env.port_pipe(mode, **SCALE_OUT) as pipe, \
            env.ref_pipe(mode, **SCALE_OUT) as ref:
        for _ in range(2):
            resp, want = pipe.search(*q), ref.search(*q)
            assert_parity(want, resp)
            bd = resp.breakdown
            assert bd.total_s == pytest.approx(
                bd.encode_s + bd.ann_s + bd.critical_io_s + bd.rerank_s
                + 0.2e-3)
            assert bd.bytes_read + bd.dedup_bytes_saved == sum(
                r.bow_bytes_read for r in resp.ranked)
        st = pipe.tier.stats
        assert st["hedge_bytes"] % env.layout.block == 0
        assert st["cache_hits"] > 0
        assert st["hedged_reads"] >= st["hedge_wins"]
        assert_same_counters(ref.tier, pipe.tier)


def test_cluster_io_attribution_sums_to_batch_clock():
    ref, layout = mini()
    clus = cluster.StorageCluster(layout, n_shards=3, t_max=48, device="cpu")
    rclus = ref_cluster.StorageCluster(ref, n_shards=3, t_max=48)
    lists = [np.arange(20), np.arange(10, 30), np.array([5])]
    res, want = clus.read_batch(lists), rclus.read_batch(lists)
    assert sum(res.io_s(b) for b in range(3)) == pytest.approx(
        res.sim_seconds, rel=1e-12)
    assert [res.io_s(b) for b in range(3)] == [want.io_s(b)
                                               for b in range(3)]
    assert_rows_equal(port_rows(res), ref_rows(want))
    clus.close(), rclus.close()


# -- hedged reads ------------------------------------------------------------

@pytest.mark.parametrize("t_primary,t_secondary,after", [
    (0.100, 0.002, 0.005), (0.004, 0.002, 0.005), (0.006, 0.100, 0.005)])
def test_hedge_clock_primitive(t_primary, t_secondary, after):
    got = cluster.hedge_clock(t_primary, lambda: t_secondary, after)
    assert got == ref_cluster.hedge_clock(t_primary, lambda: t_secondary,
                                          after)


def test_degraded_primary_hedges_and_wins():
    ref, layout = mini()
    lists = [np.arange(30), np.arange(15, 45)]
    kw = dict(n_shards=2, replication=2, replica_mults=[5.0, 1.0], t_max=48)
    unhedged = cluster.StorageCluster(layout, device="cpu", **kw)
    hedged = cluster.StorageCluster(layout, hedge_quantile=0.9,
                                    device="cpu", **kw)
    rhedged = ref_cluster.StorageCluster(ref, hedge_quantile=0.9, **kw)
    ru, rh, rr = (x.read_batch(lists) for x in (unhedged, hedged, rhedged))
    assert rh.sim_seconds < ru.sim_seconds
    assert rh.sim_seconds == rr.sim_seconds
    assert hedged.stats["hedged_reads"] == hedged.stats["hedge_wins"] == 2
    assert hedged.stats["hedge_bytes"] == ru.n_blocks * layout.block
    assert rh.hedge_blocks == ru.n_blocks == rr.hedge_blocks
    assert unhedged.stats["hedge_bytes"] == 0
    assert hedged.stats == rhedged.stats
    assert_rows_equal(port_rows(rh), port_rows(ru))
    assert_rows_equal(port_rows(rh), ref_rows(rr))
    unhedged.close(), hedged.close(), rhedged.close()


def test_hedged_never_slower_pointwise_under_jitter():
    """Same seed, same trace: hedging only ever replaces a draw with
    min(primary, delay + secondary), and every batch's clock is the
    reference's."""
    ref, layout = mini()
    rng = np.random.default_rng(0)
    trace = [[rng.integers(0, 60, 12) for _ in range(4)] for _ in range(20)]
    kw = dict(n_shards=2, replication=2, replica_mults=[3.0, 1.0],
              jitter_sigma=0.3, seed=11, t_max=48)
    a = cluster.StorageCluster(layout, device="cpu", **kw)
    b = cluster.StorageCluster(layout, hedge_quantile=0.9, device="cpu", **kw)
    rb = ref_cluster.StorageCluster(ref, hedge_quantile=0.9, **kw)
    for lists in trace:
        ra, rh, rr = a.read_batch(lists), b.read_batch(lists), \
            rb.read_batch(lists)
        assert rh.sim_seconds <= ra.sim_seconds + 1e-15
        assert rh.sim_seconds == rr.sim_seconds
    assert b.stats["hedge_wins"] > 0
    assert b.stats == rb.stats
    a.close(), b.close(), rb.close()


def test_no_hedging_without_replicas():
    _, layout = mini()
    clus = cluster.StorageCluster(layout, n_shards=2, replication=1,
                                  hedge_quantile=0.9, t_max=48, device="cpu")
    clus.read_batch([np.arange(20)]).wait_all()
    assert clus.stats["hedged_reads"] == 0
    assert clus.stats["hedge_bytes"] == 0
    clus.close()


# -- cross-batch arena cache -------------------------------------------------

def test_arena_cache_serves_repeat_batches_for_free():
    """The second batch is served from the cache (no clock, no blocks);
    its rows decode to the layout's docs, as the reference's do."""
    ref, layout = mini()
    clus = cluster.StorageCluster(layout, n_shards=2,
                                  arena_cache_bytes=1 << 20, t_max=48,
                                  device="cpu")
    rclus = ref_cluster.StorageCluster(ref, n_shards=2,
                                       arena_cache_bytes=1 << 20, t_max=48)
    lists = [np.array([3, 8, 1]), np.array([8, 40])]
    r1, w1 = clus.read_batch(lists), rclus.read_batch(lists)
    r1.wait_all()
    assert r1.sim_seconds == w1.sim_seconds > 0 and r1.cache_hits == 0
    r2, w2 = clus.read_batch(lists), rclus.read_batch(lists)
    assert r2.sim_seconds == 0.0 and r2.n_blocks == 0
    assert r2.cache_hits == w2.cache_hits == 4
    got = port_rows(r2)
    assert_rows_equal(got, ref_rows(w2))
    for b, ids in enumerate(lists):
        _, row_map, io_s = r2.view(b)
        assert io_s == 0.0
        for i in ids:
            np.testing.assert_array_equal(got[row_map[int(i)]],
                                          unpack_doc(layout, int(i))[1])
    assert clus.stats == rclus.stats
    clus.close(), rclus.close()


def test_arena_cache_narrow_rows_not_served_wider():
    """A row staged under a small t_max must not serve a wider read."""
    cache, ref = ArenaCache(1 << 20, d_cls=4), RefArenaCache(1 << 20)
    cache.put(7, np.zeros((6, 8), np.float16), 6)
    ref.put(7, np.zeros(4, np.float32), np.zeros((6, 8), np.float32), 6)
    assert cache.get(7, 6) is not None and ref.get(7, 6) is not None
    assert cache.get(7, 10) is None and ref.get(7, 10) is None
    assert cache.stats() == ref.stats()
    assert cache.hits == 1 and cache.misses == 1


def test_arena_cache_budget_evicts_lru():
    """The budget is charged at the reference's fp32 row size, so the same
    puts evict the same entries."""
    row_bytes = 4 * 4 + 6 * 8 * 4
    cache, ref = ArenaCache(3 * row_bytes, d_cls=4), \
        RefArenaCache(3 * row_bytes)
    for i in range(5):
        cache.put(i, np.zeros((6, 8), np.float16), 6)
        ref.put(i, np.zeros(4, np.float32), np.zeros((6, 8), np.float32), 6)
    assert len(cache) == 3 and cache.evictions == 2
    assert cache.stats() == ref.stats()
    assert cache.bytes_used <= cache.capacity_bytes
    assert cache.get(0, 6) is None and cache.get(4, 6) is not None
    cache.clear()
    assert len(cache) == 0 and cache.bytes_used == 0


def test_disabled_cache_is_inert():
    cache = ArenaCache(0, d_cls=4)
    cache.put(1, np.zeros((2, 8), np.float16), 2)
    assert len(cache) == 0 and not cache.enabled


def test_failed_rows_never_poison_the_arena_cache():
    """A dead shard's rows are never cached: the next batch still misses
    them, as in the reference."""
    ref, layout = mini(n=80)
    kw = dict(n_shards=2, replication=1, t_max=64,
              arena_cache_bytes=1 << 20)
    clus = cluster.StorageCluster(layout, device="cpu", **kw)
    rclus = ref_cluster.StorageCluster(ref, **kw)
    for c in (clus, rclus):
        c._replica_alive[0] = [False]
    on0 = np.flatnonzero(clus.shard_of == 0)
    on1 = np.flatnonzero(clus.shard_of == 1)
    for _ in range(2):
        res = clus.read_batch([on0[:6], on1[:4]])
        want = rclus.read_batch([on0[:6], on1[:4]])
        assert res.query_failed(0) and not res.query_failed(1)
        res.wait_all()
    assert len(clus.arena_cache) == len(rclus.arena_cache) == 4
    assert clus.stats == rclus.stats
    assert_rows_equal(port_rows(res, res.plan.query_rows[1]),
                      ref_rows(want, want.plan.query_rows[1]))
    clus.close(), rclus.close()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_corruption_and_cache_rows(dtype, checksum):
    """fp16, and int8 with per-doc scales, on 2 shards with the arena
    cache, every shard read drawing a wire corruption: an undetected one
    flips the victim's staged rows (fp16) or negates its scale (int8), so
    its decoded rows are the reference's flipped rows, in the batch and
    when served again from the cache; a detected one is repaired and
    billed. Rows, clocks and counters equal the reference's over three
    batches."""
    rng = np.random.default_rng(4)
    cls = rng.standard_normal((80, 16)).astype(np.float32) * 20
    bow = [rng.standard_normal((int(t), 8)).astype(np.float32) * 20
           for t in rng.integers(4, 40, 80)]
    scales = (rng.uniform(0.5, 2.0, 80).astype(np.float32)
              if dtype == "int8" else None)
    ref = ref_pack(cls, bow, dtype=np.dtype(dtype), checksum=checksum,
                   scales=scales)
    layout = convert.layout_from_numpy(layout_arrays(ref))
    layout.checksums = ref.checksums
    fk = dict(corruption_rate=1.0, checksum=checksum, seed=7)
    kw = dict(n_shards=2, t_max=48, arena_cache_bytes=1 << 20)
    clus = cluster.StorageCluster(layout, device="cpu",
                                  faults=FaultInjector(FaultConfig(**fk)),
                                  **kw)
    rclus = ref_cluster.StorageCluster(
        ref, faults=RefFaultInjector(RefFaultConfig(**fk)), **kw)
    for lists in ([np.arange(0, 30), np.arange(20, 50)],
                  [np.arange(10, 40)], [np.arange(0, 50, 3)]):
        got, want = clus.read_batch(lists), rclus.read_batch(lists)
        assert got.sim_seconds == want.sim_seconds
        assert_rows_equal(port_rows(got), ref_rows(want))
    assert clus.stats["corruptions_injected"] > 0
    assert clus.stats["cache_hits"] > 0
    assert clus.stats == rclus.stats
    clus.close(), rclus.close()


# -- close semantics (in-flight hedged + async batch reads) ------------------

def test_cluster_close_idempotent_and_guards_reads():
    _, layout = mini()
    clus = cluster.StorageCluster(layout, n_shards=2, replication=2,
                                  replica_mults=[5.0, 1.0],
                                  hedge_quantile=0.9, t_max=48, device="cpu")
    clus.read_batch([np.arange(10)]).wait_all()
    billed = dict(clus.stats)
    clus.close()
    clus.close()
    with pytest.raises(RuntimeError):
        clus.read_batch([np.arange(10)])
    with pytest.raises(RuntimeError):
        clus.read([1, 2])
    assert clus.stats == billed


def test_close_with_inflight_batch_leaves_no_abandoned_futures():
    """Close while a hedged batch's staging is gated: every run future
    resolves (result or CancelledError), never hangs, and close neither
    drops nor duplicates the batch's bill (the reference's bill)."""
    ref, layout = mini()
    kw = dict(n_shards=2, replication=2, replica_mults=[5.0, 1.0],
              hedge_quantile=0.9, io_chunk_docs=4, t_max=48)
    clus = cluster.StorageCluster(layout, device="cpu", **kw)
    rclus = ref_cluster.StorageCluster(ref, **kw)
    gate = threading.Event()
    orig = clus._gather_run

    def gated(*a, **k):
        assert gate.wait(timeout=30)
        return orig(*a, **k)

    clus._gather_run = gated
    try:
        res = clus.read_batch([np.arange(40)])
        rclus.read_batch([np.arange(40)]).wait_all()
        billed = dict(clus.stats)
        assert billed == rclus.stats
        assert billed["hedged_reads"] == 2 and billed["hedge_bytes"] > 0
        clus.close()
        gate.set()
        resolved = 0
        for f in res._futures:
            try:
                f.result(timeout=30)
            except CancelledError:
                pass
            resolved += 1
        assert resolved == len(res._futures) > 0
        assert clus.stats == billed
    finally:
        gate.set()
        clus.close(), rclus.close()


def test_cluster_read_async_cancelled_on_close():
    _, layout = mini()
    clus = cluster.StorageCluster(layout, t_max=48, n_io_threads=1,
                                  device="cpu")
    started, release = threading.Event(), threading.Event()
    real_read = clus.read

    def slow_read(ids, t_max=None):
        out = real_read(ids, t_max)
        started.set()
        release.wait(timeout=10)
        return out

    clus.read = slow_read
    running = clus.read_async([0])
    assert started.wait(timeout=10)
    pending = [clus._pool.submit(slow_read, [1]) for _ in range(3)]
    clus.close()
    release.set()
    assert running.result(timeout=10) is not None

    def resolved_cancelled(f):
        try:
            f.result(timeout=10)
            return False
        except CancelledError:
            return True

    assert any(resolved_cancelled(f) for f in pending)


# -- faults: per-shard containment, retries, failover ------------------------

def test_checksums_survive_sharding():
    _, layout = mini(checksum=True)
    clus = cluster.StorageCluster(layout, n_shards=3, t_max=64, device="cpu")
    for sh in clus.shards:
        assert sh.layout.checksums is not None
        assert verify_checksums(sh.layout).all()
    clus.close()


def test_retry_then_failover_keeps_reads_alive():
    """Twelve blocking reads through the retry/failover machine draw the
    reference's faults: the same clocks and counters, and rows equal."""
    ref, layout = mini(n=80)
    fk = dict(read_error_rate=0.35, read_retries=1, seed=2)
    kw = dict(n_shards=2, replication=2, t_max=64)
    clus = cluster.StorageCluster(layout, device="cpu",
                                  faults=FaultInjector(FaultConfig(**fk)),
                                  **kw)
    rclus = ref_cluster.StorageCluster(
        ref, faults=RefFaultInjector(RefFaultConfig(**fk)), **kw)
    for i in range(12):
        ids = np.arange(i, i + 10) % layout.n_docs
        r, w = clus.read(ids), rclus.read(ids)
        assert r.sim_seconds == w.sim_seconds > 0
        assert_rows_equal(read_rows(r), [w.bow[j, :w.lens[j]]
                                         for j in range(len(ids))])
    assert clus.stats["read_errors"] > 0 and clus.stats["retries"] > 0
    assert clus.stats["shard_read_failures"] == 0
    assert clus.stats == rclus.stats
    clus.close(), rclus.close()


def test_retry_exhaustion_raises_and_bills_burned_time():
    ref, layout = mini()
    fk = dict(read_error_rate=1.0, read_retries=1, seed=0)
    clus = cluster.StorageCluster(layout, t_max=64, device="cpu",
                                  faults=FaultInjector(FaultConfig(**fk)))
    rclus = ref_cluster.StorageCluster(
        ref, t_max=64, faults=RefFaultInjector(RefFaultConfig(**fk)))
    with pytest.raises(ShardReadError):
        clus.read(np.arange(8))
    with pytest.raises(RefShardReadError):
        rclus.read(np.arange(8))
    assert clus.stats["sim_seconds"] > 0
    assert clus.stats["shard_read_failures"] == 1
    assert clus.stats == rclus.stats
    clus.close(), rclus.close()


def test_dead_shard_fails_per_shard_not_whole_batch():
    """One dead shard fails only the queries that touch it; the healthy
    query's rows land and equal the reference's."""
    ref, layout = mini(n=80)
    clus = cluster.StorageCluster(layout, n_shards=2, replication=1,
                                  t_max=64, device="cpu")
    rclus = ref_cluster.StorageCluster(ref, n_shards=2, replication=1,
                                       t_max=64)
    for c in (clus, rclus):
        c._replica_alive[0] = [False]
    on0 = np.flatnonzero(clus.shard_of == 0)
    on1 = np.flatnonzero(clus.shard_of == 1)
    lists = [on0[:6], on1[:6], np.concatenate([on0[:3], on1[:3]])]
    res, want = clus.read_batch(lists), rclus.read_batch(lists)
    assert res.any_failed
    assert [res.query_failed(b) for b in range(3)] == [True, False, True] \
        == [want.query_failed(b) for b in range(3)]
    rows = res.plan.query_rows[1]
    assert_rows_equal(port_rows(res, rows), ref_rows(want, rows))
    assert clus.stats == rclus.stats
    with pytest.raises(ShardReadError):
        clus.read(on0[:4])
    clus.close(), rclus.close()


@pytest.mark.parametrize("mode", ["espn", "gds", "cascade"])
def test_killed_replica_fails_over_and_recovery_bills_resync(env, mode):
    """A killed replica's turns fail over to its peer (no degraded query,
    the rankings unchanged); ``recover_replica`` bills the shard image's
    re-sync bytes and seconds; every counter equals the reference's."""
    c = env.corpus
    q = (c.queries_cls[:6], c.queries_bow[:6], c.query_lens[:6])
    kw = dict(n_shards=2, replication=2)
    with env.port_pipe(mode, **kw) as pipe, env.ref_pipe(mode, **kw) as ref:
        first, rfirst = pipe.search(*q), ref.search(*q)
        for p in (pipe, ref):
            p.kill_replica(0, 1)
        got = [pipe.search(*q) for _ in range(2)]
        want = [ref.search(*q) for _ in range(2)]
        for g, w in zip(got, want):
            assert_parity(w, g)
            assert g.breakdown.degraded_queries == 0
            assert_bitwise(first, g)
        assert pipe.tier.stats["failovers"] > 0
        rec, rrec = pipe.recover_replica(0, 1), ref.recover_replica(0, 1)
        assert rec == rrec and rec["bytes"] == \
            pipe.tier._shard_disk_blocks(0) * env.layout.block
        assert_parity(rfirst, first)
        assert_same_counters(ref.tier, pipe.tier)
        assert pipe.tier.replica_status() == [[True, True], [True, True]]


# -- config / persistence / plumbing -----------------------------------------

def test_cluster_config_round_trips():
    cfg = PipelineConfig()
    cfg.cluster = ClusterConfig(n_shards=4, replication=2,
                                replica_mults=[3.0, 1.0],
                                hedge_quantile=0.95, jitter_sigma=0.25,
                                arena_cache_mb=8.0, seed=3)
    again = PipelineConfig.from_dict(cfg.to_dict())
    assert again.cluster == cfg.cluster and again.cluster.enabled()
    ref = RefConfig.from_dict(cfg.to_dict())
    assert dataclasses.asdict(ref.cluster) == dataclasses.asdict(cfg.cluster)
    d = cfg.to_dict()
    del d["cluster"]
    legacy = PipelineConfig.from_dict(d)
    assert legacy.cluster == ClusterConfig()
    assert not legacy.cluster.enabled()


def test_cluster_cli_round_trip():
    argv = ["--shards", "4", "--replication", "2", "--hedge-quantile", "0.95",
            "--replica-mults", "3.0,1.0", "--arena-cache-mb", "8",
            "--cluster-jitter", "0.25", "--partition", "range",
            "--cluster-seed", "3"]
    cfg = PipelineConfig.from_cli(
        PipelineConfig.add_cli_args(argparse.ArgumentParser()).parse_args(
            argv))
    assert cfg.cluster == ClusterConfig(
        n_shards=4, replication=2, partition="range", hedge_quantile=0.95,
        jitter_sigma=0.25, replica_mults=[3.0, 1.0], arena_cache_mb=8.0,
        seed=3)
    ref = RefConfig.from_cli(
        RefConfig.add_cli_args(argparse.ArgumentParser()).parse_args(argv))
    assert cfg.to_dict() == ref.to_dict()


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_save_load_sharded_pipeline_across_packages(env, tmp_path, saver):
    """A sharded directory saved by either package holds ``shards/``, and
    the other package loads it onto a cluster with the same shard map and
    answers as the saver did."""
    q = dup_queries(env.corpus)
    kw = dict(n_shards=3, partition="range")
    out = str(tmp_path / "art")
    first = env.port_pipe("gds", **kw) if saver == "port" \
        else env.ref_pipe("gds", **kw)
    with first:
        want = first.search(*q)
        first.save(out)
        ids = [np.asarray(g) for g in first.tier.shard_ids]
    assert (tmp_path / "art" / "shards" / "shard_2.npz").exists()
    if saver == "port":
        again = RefPipeline.load(out)
        assert isinstance(again.tier, ref_cluster.StorageCluster)
    else:
        again = Pipeline.load(out, device="cpu")
        assert isinstance(again.tier, cluster.StorageCluster)
    with again:
        for s in range(3):
            np.testing.assert_array_equal(again.tier.shard_ids[s], ids[s])
        got = again.search(*q)
    if saver == "port":
        assert_parity(got, want)
    else:
        assert_parity(want, got)


def test_with_mode_reuses_shard_layouts(env):
    with env.port_pipe("gds", n_shards=2) as pipe:
        with pipe.with_mode("dram") as other:
            assert isinstance(other.tier, cluster.StorageCluster)
            for s in range(2):
                assert other.tier.shards[s].layout is \
                    pipe.tier.shards[s].layout


def test_per_shard_dedup_signal():
    """Shard-level doc_requests counts requests reaching the device,
    duplicates included, so doc_requests - docs is the shard's dedup
    saving; the per-shard counters equal the reference's."""
    ref, layout = mini()
    clus = cluster.StorageCluster(layout, n_shards=2, t_max=48, device="cpu")
    rclus = ref_cluster.StorageCluster(ref, n_shards=2, t_max=48)
    lists = [np.array([3, 8, 1]), np.array([8, 3, 40])]
    clus.read_batch(lists).wait_all()
    rclus.read_batch(lists).wait_all()
    shards = clus.per_shard_stats()
    assert sum(st["doc_requests"] for st in shards) == 6
    assert sum(st["docs"] for st in shards) == 4
    assert sum(st["dedup_docs"] for st in shards) == 2
    assert shards == rclus.per_shard_stats()
    clus.close(), rclus.close()


def test_memory_accounting_counts_cache_budget(env):
    clus = cluster.StorageCluster(env.layout, n_shards=2,
                                  arena_cache_bytes=1 << 20, t_max=64,
                                  device="cpu")
    plain = StorageTier(env.layout, stack="espn", t_max=64, device="cpu")
    rclus = ref_cluster.StorageCluster(env.base.layout, n_shards=2,
                                       arena_cache_bytes=1 << 20, t_max=64)
    assert clus.memory_resident_bytes() >= \
        plain.memory_resident_bytes() + (1 << 20)
    assert clus.memory_resident_bytes() == rclus.memory_resident_bytes()
    assert RefTier(env.base.layout, t_max=64).memory_resident_bytes() == \
        plain.memory_resident_bytes()
    clus.close(), plain.close(), rclus.close()


def test_cluster_metrics_sources(env):
    """The cluster, each shard and the arena cache expose their counters,
    named as the reference names them."""
    with env.port_pipe("gds", **SCALE_OUT) as pipe, \
            env.ref_pipe("gds", **SCALE_OUT) as ref:
        c = env.corpus
        q = (c.queries_cls[:4], c.queries_bow[:4], c.query_lens[:4])
        pipe.search(*q), ref.search(*q)
        got = pipe.tier.metrics_sources()
        want = ref.tier.metrics_sources()
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g() == w()
        text = pipe.metrics_text()
        assert "storage_cluster_hedged_reads" in text
        assert "arena_cache_hits" in text
