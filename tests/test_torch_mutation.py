"""The port's live index mutation against the JAX package's, on the CPU, at
400 docs: online ingest, tombstone delete, compaction, rebalancing,
``maintain`` and the background compactor over ``MutableStorageCluster``,
the segment plumbing, ``ivf_add``, the side tables' appends and the arena
cache's invalidation. Each case of ``tests/test_mutation.py`` has its
counterpart here, the save and load of a mutable tier (the reference's
``mutation/`` directory) across the packages included.

Both packages run on the same artifacts (the reference builds the index,
the layout and the resident tables; ``repro_torch.convert`` carries them
across) and take the same ingests and deletes. Ids, simulated clocks, byte
bills, reports and counters must be equal; scores within ``SCORE_TOL``
(fp32 sums taken in another order). Within the port, a churned pipeline
must rank exactly like a stack rebuilt from scratch over the surviving
docs: ids and scores bit for bit, as the reference's own churn test holds
the reference.
"""
import argparse
import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_parity import (SCORE_TOL, bits_arrays, fde_arrays, index_arrays,
                           layout_arrays)
from repro.core.ivf import build_ivf as ref_build_ivf
from repro.core.ivf import ivf_add as ref_ivf_add
from repro.data.synthetic import make_corpus as ref_make_corpus
from repro.pipeline import MutationConfig as RefMutationConfig
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.pipeline.pipeline import _pack_layout as ref_pack_layout
from repro.storage import segments as ref_segments
from repro.storage.arena_cache import ArenaCache as RefArenaCache
from repro.storage.layout import pack as ref_pack
from repro.storage.layout import unpack_doc as ref_unpack
from repro.storage.mutation import MutableStorageCluster as RefMutable
from repro_torch import convert
from repro_torch.core.fde import fde_from_layout
from repro_torch.core.ivf import build_ivf, ivf_add, ivf_add_plain
from repro_torch.pipeline import (MutationConfig, Pipeline, PipelineConfig,
                                  available_backends)
from repro_torch.pipeline.pipeline import _pack_layout
from repro_torch.storage import segments
from repro_torch.storage.arena_cache import ArenaCache
from repro_torch.storage.layout import bits_from_layout, pack, unpack_doc
from repro_torch.storage.mutation import MutableStorageCluster

MODES = sorted(available_backends())
CHURN_MODES = ["espn", "bitvec", "fde", "cspn", "cascade"]


@functools.lru_cache(maxsize=1)
def corpus():
    return ref_make_corpus(n_docs=400, n_queries=8, n_clusters=8,
                           mean_len=12, max_len=24, seed=3)


def base_cfg(mode="espn", *, mutation=False, cluster=False, port=False,
             **mut_kw):
    """The reference test's config, in either package."""
    cfg = PipelineConfig() if port else RefConfig()
    cfg.index.ncells = 16
    cfg.retrieval.mode = mode
    cfg.retrieval.nprobe = 8
    cfg.retrieval.k = 10
    cfg.retrieval.k_candidates = 30
    cfg.mutation = (MutationConfig if port else RefMutationConfig)(
        enabled=mutation, **mut_kw)
    if cluster:
        cfg.cluster.n_shards = 2
        cfg.cluster.replication = 2
        cfg.cluster.hedge_quantile = 0.9
        cfg.cluster.jitter_sigma = 0.3
        cfg.cluster.replica_mults = [1.0, 1.3]
    return cfg


@functools.lru_cache(maxsize=None)
def ref_artifacts(layout_mode="ragged"):
    """The reference's index over the 400 docs and its layout."""
    c = corpus()
    cfg = base_cfg()
    if layout_mode == "fixed_stride":
        cfg.storage.layout_mode, cfg.storage.pool_k = "fixed_stride", 8
    index = ref_build_ivf(c.cls, ncells=16, iters=cfg.index.iters,
                          quant=cfg.index.quant,
                          train_sample=cfg.index.train_sample)
    return index, ref_pack_layout(cfg, c.cls, c.bow)


def pair(mode="espn", *, layout_mode="ragged", arena_cache_mb=0.0, **kw):
    """The reference's and the port's pipelines on the same artifacts (the
    port takes the reference's resident tables). Each gets its own index
    object: ``ingest`` grows it in place."""
    rcfg = base_cfg(mode, **kw)
    rcfg.cluster.arena_cache_mb = arena_cache_mb
    if layout_mode == "fixed_stride":
        rcfg.storage.layout_mode, rcfg.storage.pool_k = "fixed_stride", 8
    pcfg = PipelineConfig.from_dict(rcfg.to_dict())
    index, layout = ref_artifacts(layout_mode)
    ref = RefPipeline.from_artifacts(rcfg, index=dataclasses.replace(index),
                                     layout=layout, corpus=corpus())
    tables = {}
    if ref.tier.bits is not None:
        tables["bits"] = convert.bit_table_from_numpy(
            bits_arrays(ref.tier.bits))
    if ref.tier.fde is not None:
        tables["fde"] = convert.fde_table_from_numpy(
            fde_arrays(ref.tier.fde), "cpu")
    port = Pipeline.from_artifacts(
        pcfg, index=convert.ivf_index_from_numpy(index_arrays(index), "cpu"),
        layout=convert.layout_from_numpy(layout_arrays(layout)),
        corpus=corpus(), device="cpu", **tables)
    return ref, port


def new_docs(rng, n, d_cls=None, d_bow=None):
    """The reference test's fresh docs (unit CLS, 3-9 unit tokens)."""
    c = corpus()
    d_cls = d_cls or c.cls.shape[1]
    d_bow = d_bow or c.bow[0].shape[1]
    cls = rng.standard_normal((n, d_cls)).astype(np.float32)
    cls /= np.linalg.norm(cls, axis=1, keepdims=True)
    bows = []
    for _ in range(n):
        b = rng.standard_normal((int(rng.integers(3, 10)),
                                 d_bow)).astype(np.float32)
        bows.append(b / np.linalg.norm(b, axis=1, keepdims=True))
    return cls, bows


def queries():
    c = corpus()
    return c.queries_cls, c.queries_bow, c.query_lens


def assert_parity(want, got):
    """The port's response against the reference's: ids equal, scores
    within ``SCORE_TOL``, per-query and batch bills equal."""
    assert len(want.ranked) == len(got.ranked)
    for w, g in zip(want.ranked, got.ranked):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0,
                                   atol=SCORE_TOL)
        assert (g.n_reranked, g.bow_bytes_read, g.degraded) == (
            w.n_reranked, w.bow_bytes_read, w.degraded)
    assert got.breakdown.as_dict() == want.breakdown.as_dict()


def assert_bitwise(want, got):
    for w, g in zip(want.ranked, got.ranked):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


def both(ref, port, fn):
    """Apply the same mutation to both pipelines; return both results."""
    return fn(ref), fn(port)


# -- no-mutation identity -----------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_unmutated_mutable_cluster_is_bitwise_identical(mode):
    """With zero mutations the mutable tier reproduces the immutable path
    bit for bit (ids, scores, the whole bill) in every mode, on the
    trivial and the sharded, hedged cluster; and it answers and bills as
    the reference's mutable tier does."""
    for cluster in (False, True):
        ref, port = pair(mode, mutation=True, cluster=cluster)
        cfg = PipelineConfig.from_dict(port.cfg.to_dict())
        cfg.mutation = MutationConfig()
        with ref, port, Pipeline.from_artifacts(
                cfg, index=port.index, layout=port.layout,
                corpus=corpus(), device="cpu", bits=port.tier.bits,
                fde=port.tier.fde) as plain:
            assert isinstance(port.tier, MutableStorageCluster)
            assert not isinstance(plain.tier, MutableStorageCluster)
            a, b = plain.search(), port.search()
            assert_bitwise(a, b)
            assert a.breakdown.as_dict() == b.breakdown.as_dict()
            assert_parity(ref.search(), b)
            assert port.tier.stats == ref.tier.stats


# -- ingest ---------------------------------------------------------------------

def test_ingest_makes_docs_retrievable():
    ref, port = pair(mutation=True)
    with ref, port:
        cls, bows = new_docs(np.random.default_rng(1), 3)
        rg, gids = both(ref, port, lambda p: p.ingest(cls, bows))
        np.testing.assert_array_equal(gids, [400, 401, 402])
        np.testing.assert_array_equal(gids, rg)
        assert port.layout.n_docs == 403 and port.index.n_docs == 403
        # each new doc, queried with its own embeddings, ranks first
        q_bow = np.zeros((3, 24, port.layout.d_bow), np.float32)
        for i, b in enumerate(bows):
            q_bow[i, :len(b)] = b
        q_lens = np.array([len(b) for b in bows], np.int32)
        got = port.search(cls, q_bow, q_lens)
        for i, r in enumerate(got.ranked):
            assert r.doc_ids[0] == gids[i]
        assert_parity(ref.search(cls, q_bow, q_lens), got)
        st_ = port.tier.stats
        assert st_["ingests"] == 1 and st_["ingested_docs"] == 3
        assert st_["ingest_bytes"] > 0 and st_["ingest_seconds"] > 0
        assert st_ == ref.tier.stats


@pytest.mark.parametrize("mode", ["bitvec", "fde", "cascade"])
def test_ingest_side_tiers_match_rebuild(mode):
    """The appended bit and FDE tables equal a from-scratch rebuild of the
    grown layout (the storage-quantized rows, not the fp32 inputs) bit for
    bit; the bit table equals the reference's bit for bit, the FDEs agree
    with its within fp32 rounding of the SimHash sign tests."""
    ref, port = pair(mode, mutation=True)
    with ref, port:
        rng = np.random.default_rng(2)
        for n in (5, 1, 7):                   # appends of several sizes
            docs = new_docs(rng, n)
            both(ref, port, lambda p: p.ingest(*docs))
        t, rt = port.tier, ref.tier
        if t.bits is not None:
            rebuilt = bits_from_layout(port.layout,
                                       dtype=str(t.bits.packed.dtype))
            np.testing.assert_array_equal(t.bits.packed, rebuilt.packed)
            np.testing.assert_array_equal(t.bits.starts, rebuilt.starts)
            np.testing.assert_array_equal(t.bits.packed, rt.bits.packed)
            np.testing.assert_array_equal(t.bits.starts, rt.bits.starts)
        if t.fde is not None:
            n0 = corpus().n_docs
            rebuilt = fde_from_layout(port.layout, t.fde.cfg,
                                      dtype=str(t.fde.vecs.dtype)
                                      .split(".")[-1], device="cpu")
            # the carried-across base rows are the reference's; the rows
            # the port appended are its own encoder's, equal to its rebuild
            assert torch.equal(t.fde.vecs[n0:], rebuilt.vecs[n0:])
            a = t.fde.vecs[n0:].float().numpy()
            b = np.asarray(rt.fde.vecs[n0:], np.float32)
            cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))
            assert cos.min() > 0.98
            assert t.fde.vecs.shape == rt.fde.vecs.shape
        assert_parity(ref.search(), port.search())


@pytest.mark.parametrize("mode", ["bitvec", "fde", "cascade"])
def test_own_tables_after_ingest_equal_a_rebuild(mode):
    """A pipeline that built its own tables: after ingests, the tables equal
    ``bits_from_layout``/``fde_from_layout`` of the grown layout bit for
    bit, over every row."""
    cfg = base_cfg(mode, mutation=True, port=True)
    c = corpus()
    with Pipeline.build(cfg, corpus=c, device="cpu") as pipe:
        rng = np.random.default_rng(12)
        for n in (4, 9):
            pipe.ingest(*new_docs(rng, n))
        t = pipe.tier
        if t.bits is not None:
            rebuilt = bits_from_layout(pipe.layout,
                                       dtype=str(t.bits.packed.dtype))
            np.testing.assert_array_equal(t.bits.packed, rebuilt.packed)
        if t.fde is not None:
            rebuilt = fde_from_layout(pipe.layout, t.fde.cfg,
                                      dtype=str(t.fde.vecs.dtype)
                                      .split(".")[-1], device="cpu")
            assert torch.equal(t.fde.vecs, rebuilt.vecs)


def test_single_doc_and_query_encodings():
    """``encode_doc``/``encode_query`` (the reference's single-row
    encoders) are the batch encoders' rows, and agree with the
    reference's within fp32 rounding of the sign tests."""
    from repro.core.fde import FDEConfig as RefFDEConfig
    from repro.core.fde import FDEEncoder as RefFDEEncoder
    from repro_torch.core.fde import FDEConfig, FDEEncoder
    c = corpus()
    d_bow = c.bow[0].shape[1]
    enc, ref = FDEEncoder(FDEConfig(d_bow=d_bow), "cpu"), \
        RefFDEEncoder(RefFDEConfig(d_bow=d_bow))
    docs = enc.encode_docs(c.bow[:5])
    qs = enc.encode_queries(c.queries_bow[:3], c.query_lens[:3])
    for i in range(5):
        assert torch.equal(enc.encode_doc(c.bow[i]), docs[i])
        np.testing.assert_allclose(enc.encode_doc(c.bow[i]).numpy(),
                                   ref.encode_doc(c.bow[i]), atol=1e-5)
    for i in range(3):
        toks = c.queries_bow[i][:int(c.query_lens[i])]
        assert torch.equal(enc.encode_query(toks), qs[i])
        np.testing.assert_allclose(enc.encode_query(toks).numpy(),
                                   ref.encode_query(toks), atol=1e-4)


# -- delete / tombstones --------------------------------------------------------

@pytest.mark.parametrize("mode", ["espn", "bitvec", "fde"])
def test_deleted_docs_never_surface(mode):
    # a 4 MB arena cache: deletion must also purge it
    ref, port = pair(mode, mutation=True, cluster=True, arena_cache_mb=4)
    with ref, port:
        r0 = port.search()
        assert_parity(ref.search(), r0)
        # the current top hit of every query, warmed into the arena cache
        victims = sorted({int(r.doc_ids[0]) for r in r0.ranked})
        # (in the cache, or in the inserts deferred to the next flush)
        assert port.tier.arena_cache.stats()["entries"] \
            or port.tier._cache_pending
        rn, n = both(ref, port, lambda p: p.delete(victims))
        assert n == rn == len(victims)
        assert port.tier.arena_cache.stats()["entries"] > 0
        assert not set(victims) & set(port.tier.arena_cache._lru)
        assert port.tier.arena_cache.stats() == ref.tier.arena_cache.stats()
        got = port.search()
        for r in got.ranked:
            assert not set(r.doc_ids.tolist()) & set(victims)
            assert (r.doc_ids >= 0).all()
        assert_parity(ref.search(), got)
        # double delete and out-of-range ids are rejected, in both
        for p in (ref, port):
            with pytest.raises(ValueError):
                p.delete([victims[0]])
            with pytest.raises(ValueError):
                p.delete([10**6])
        assert port.tier.stats["tombstones"] == len(victims)
        assert port.tier.stats == ref.tier.stats


@pytest.mark.parametrize("fetch", [True, False])
def test_prefetcher_drops_tombstones_before_the_lists_form(fetch):
    """``run_batch`` masks the tombstoned docs out of the approximate and
    final lists before the prefetch and miss lists form: the same lists,
    hit masks and stats as the reference's; ``fetch=False`` plans them and
    reads nothing (no buffers, no counter moves)."""
    from repro.core.prefetcher import ANNPrefetcher as RefPrefetcher
    from repro_torch.core.prefetcher import ANNPrefetcher
    ref, port = pair(mutation=True)
    with ref, port:
        q = corpus().queries_cls
        first = ANNPrefetcher(port.index, port.tier, prefetch_step=0.3) \
            .run_batch(q, nprobe=8, k=30, fetch=False)
        # each query's best and worst candidate
        dead = sorted({int(r.doc_ids[0]) for r in first}
                      | {int(r.doc_ids[-1]) for r in first})
        both(ref, port, lambda p: p.delete(dead))
        before, rbefore = dict(port.tier.stats), dict(ref.tier.stats)
        got = ANNPrefetcher(port.index, port.tier, prefetch_step=0.3) \
            .run_batch(q, nprobe=8, k=30, fetch=fetch)
        want = RefPrefetcher(ref.index, ref.tier, prefetch_step=0.3) \
            .run_batch(q, nprobe=8, k=30, fetch=fetch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
            np.testing.assert_array_equal(g.hit_mask, w.hit_mask)
            assert vars(g.stats) == vars(w.stats)
            assert not set(g.doc_ids.tolist()) & set(dead)
            assert not set(g.prefetched) & set(dead)
            assert (g.buffers is None) == (not fetch)
            assert g.io_failed is False
            if fetch:
                g.wait_io()
        assert port.tier.stats == ref.tier.stats
        assert (port.tier.stats["reads"] == before["reads"]) == (not fetch)
        assert before == rbefore


def test_delete_before_flush_never_caches_the_dead_row():
    """A gds batch's rows wait for the next batch's flush to enter the
    arena cache; deleting one of them first flushes, then invalidates it,
    so the dead row never lands (the reference's order: flush, flip
    ``alive``, ``remove``, bump versions)."""
    ref, port = pair("gds", mutation=True, arena_cache_mb=4)
    with ref, port:
        got = port.search()
        assert_parity(ref.search(), got)
        assert port.tier._cache_pending          # inserts still deferred
        dead = got.ranked[0].doc_ids[:3]
        both(ref, port, lambda p: p.delete(dead))
        assert not port.tier._cache_pending
        for d in dead:
            assert int(d) not in port.tier.arena_cache._lru
        assert port.tier.arena_cache.stats() == ref.tier.arena_cache.stats()
        assert_parity(ref.search(), port.search())
        assert port.tier.stats == ref.tier.stats


# -- compaction -----------------------------------------------------------------

def test_compaction_preserves_results_and_reclaims_blocks():
    ref, port = pair(mutation=True, cluster=True)
    with ref, port:
        rng = np.random.default_rng(4)
        for _ in range(3):                   # three segments of churn
            docs = new_docs(rng, 4)
            both(ref, port, lambda p: p.ingest(*docs))
        dead = rng.choice(400, 25, replace=False)
        both(ref, port, lambda p: p.delete(dead))
        before = port.search()
        assert_parity(ref.search(), before)
        phys_before = sum(port.tier._shard_disk_blocks(s)
                          for s in range(port.tier.n_shards))
        rrep, rep = both(ref, port, lambda p: p.compact())
        assert rep == rrep
        assert rep["segments_merged"] == 3
        assert rep["blocks_reclaimed"] > 0
        assert all(not segs for segs in port.tier.segments)
        phys_after = sum(port.tier._shard_disk_blocks(s)
                         for s in range(port.tier.n_shards))
        assert phys_after == phys_before - rep["blocks_reclaimed"]
        after = port.search()
        assert_bitwise(before, after)
        assert_parity(ref.search(), after)
        assert port.tier.stats["compactions"] == port.tier.n_shards
        assert port.tier.stats["compaction_bytes"] > 0
        assert port.tier.stats == ref.tier.stats
        # the compacted shard images are the reference's byte for byte
        for sh, rsh in zip(port.tier.shards, ref.tier.shards):
            np.testing.assert_array_equal(sh.layout.blob, rsh.layout.blob)
            np.testing.assert_array_equal(sh.layout.offsets,
                                          rsh.layout.offsets)


def test_segment_reads_cost_more_than_compacted_reads():
    """Read amplification: a batch spanning k segments pays k extra device
    transactions (base latency each); compaction removes them. The clocks
    and the rows read are the reference's."""
    c = corpus()
    rlayout = ref_pack(c.cls, c.bow)
    tiers = [MutableStorageCluster(
        convert.layout_from_numpy(layout_arrays(rlayout)), n_shards=1,
        coalesce=False, device="cpu"),
        RefMutable(rlayout, n_shards=1, coalesce=False)]
    try:
        rng = np.random.default_rng(5)
        gid_lists = []
        for _ in range(6):
            cls = rng.standard_normal((3, rlayout.d_cls)).astype(np.float32)
            bows = [rng.standard_normal((4, rlayout.d_bow)).astype(
                np.float32) for _ in range(3)]
            gids = [t.ingest(cls, bows) for t in tiers]
            np.testing.assert_array_equal(*gids)
            gid_lists.append(gids[0])
        ids = np.concatenate([g[:1] for g in gid_lists])  # one a segment
        tier, rtier = tiers
        r_pre, rr_pre = tier.read(ids), rtier.read(ids)
        rep, rrep = tier.compact(), rtier.compact()
        r_post, rr_post = tier.read(ids), rtier.read(ids)
        assert rep == rrep
        assert (r_pre.sim_seconds, r_post.sim_seconds) == (
            rr_pre.sim_seconds, rr_post.sim_seconds)
        assert r_post.sim_seconds < r_pre.sim_seconds      # fewer seeks
        base_lat = tier.shards[0].spec.base_latency_s
        assert r_pre.sim_seconds - r_post.sim_seconds >= 4 * base_lat
        # same bytes: the rows read before and after, and the reference's
        for j in range(len(ids)):
            rows = [r.arena.pool[int(r.arena.first[j]):][
                :int(r.arena.lens[j])].float().numpy()
                for r in (r_pre, r_post)]
            np.testing.assert_array_equal(rows[0], rows[1])
            np.testing.assert_array_equal(rows[0],
                                          rr_pre.bow[j, :len(rows[0])])
            assert len(rows[0]) == int(rr_pre.lens[j])
        assert tier.stats == rtier.stats
    finally:
        for t in tiers:
            t.close()


def test_background_compactor_runs():
    c = corpus()
    layout = pack(c.cls, c.bow)
    tier = MutableStorageCluster(layout, n_shards=1,
                                 compact_interval_s=0.02, device="cpu")
    rng = np.random.default_rng(6)
    cls = rng.standard_normal((2, layout.d_cls)).astype(np.float32)
    bows = [rng.standard_normal((4, layout.d_bow)).astype(np.float32)
            for _ in range(2)]
    tier.ingest(cls, bows)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and not tier.stats["compactions"]:
        time.sleep(0.02)
    assert tier.stats["compactions"] > 0
    assert not tier.segments[0]
    tier.close()                         # joins the daemon
    assert not tier._compactor.is_alive()


def test_maintain_thresholds_match_the_reference():
    """``maintain`` compacts the shards past their segment or dead-block
    thresholds, then rebalances on skew: the same passes, reports and
    counters as the reference's."""
    ref, port = pair(mutation=True, cluster=True, auto_compact_segments=2,
                     auto_compact_dead_frac=0.05, rebalance_skew=1.05)
    with ref, port:
        rng = np.random.default_rng(13)
        reps = []
        for step in range(3):
            docs = new_docs(rng, 3)
            both(ref, port, lambda p: p.ingest(*docs))
            dead = rng.choice(400, 12, replace=False) + 0
            dead = [int(d) for d in dead if port.tier.alive[d]]
            both(ref, port, lambda p: p.delete(dead))
            reps.append(both(ref, port, lambda p: p.maintain()))
        for rrep, rep in reps:
            assert rep == rrep
        assert any(rep["compacted"] for _, rep in reps)
        assert port.tier.stats == ref.tier.stats
        assert_parity(ref.search(), port.search())
        snap = dict(port.tier.metrics_sources())["mutation"]()
        assert snap == dict(ref.tier.metrics_sources())["mutation"]()


# -- rebalancing ----------------------------------------------------------------

def test_rebalance_moves_mass_and_bills_both_sides():
    ref, port = pair(mutation=True, cluster=True)
    with ref, port:
        t = port.tier
        # skew shard 0 by tombstoning half of its docs
        on0 = np.flatnonzero(t.alive & (t.shard_of == 0))
        both(ref, port, lambda p: p.delete(on0[: len(on0) // 2]))
        mass0 = t._live_block_mass()
        skew0 = mass0.max() - mass0.min()
        rrep, rep = both(ref, port, lambda p: p.rebalance())
        assert rep == rrep
        assert rep["moved_docs"] > 0
        assert rep["src"] != rep["dst"]
        mass1 = t._live_block_mass()
        np.testing.assert_array_equal(mass1, ref.tier._live_block_mass())
        assert mass1.max() - mass1.min() < skew0
        assert int(mass1.sum()) == int(mass0.sum())          # nothing lost
        assert t.stats["migration_bytes"] == \
            2 * rep["moved_blocks"] * t.layout.block
        assert t.stats["migration_seconds"] > 0
        # results unchanged by data placement
        got = port.search()
        assert all(len(q.doc_ids) > 0 for q in got.ranked)
        assert_parity(ref.search(), got)
        assert t.stats == ref.tier.stats


# -- replica failure / recovery -------------------------------------------------

def test_replica_kill_is_absorbed_and_recovery_is_billed():
    ref, port = pair(mutation=True, cluster=True)
    ref_d, degraded = pair(mutation=True, cluster=True)
    with ref, port, ref_d, degraded:
        # segments on the shard, so the re-sync bills them too
        docs = new_docs(np.random.default_rng(7), 5)
        for p in (ref, port, ref_d, degraded):
            p.ingest(*docs)
        both(ref_d, degraded, lambda p: p.kill_replica(0, 0))
        rh, rd = port.search(), degraded.search()
        assert_bitwise(rh, rd)                 # data path is unaffected
        assert_parity(ref_d.search(), rd)
        st_ = degraded.tier.stats
        assert st_["replicas_killed"] == 1
        assert st_["failovers"] > 0
        with pytest.raises(RuntimeError):      # can't kill the last copy
            degraded.kill_replica(0, 1)
        rrep, rep = both(ref_d, degraded, lambda p: p.recover_replica(0, 0))
        assert rep == rrep
        nb = degraded.tier._shard_disk_blocks(0)
        assert nb > int(degraded.tier.shards[0].layout.offsets[:, 1].sum())
        assert rep["bytes"] == nb * degraded.layout.block
        assert st_["recovery_bytes"] == rep["bytes"]
        assert st_["recovery_seconds"] == rep["seconds"] > 0
        assert st_["replicas_recovered"] == 1
        with pytest.raises(ValueError):        # already alive
            degraded.recover_replica(0, 0)
        assert st_ == ref_d.tier.stats


# -- with_mode, config, persistence ---------------------------------------------

def test_with_mode_carries_mutation_state():
    ref, port = pair(mutation=True, cluster=True)
    with ref, port:
        docs = new_docs(np.random.default_rng(9), 4)
        _, gids = both(ref, port, lambda p: p.ingest(*docs))
        both(ref, port, lambda p: p.delete(gids[:1]))
        with port.with_mode("bitvec") as other, \
                ref.with_mode("bitvec") as rother:
            assert isinstance(other.tier, MutableStorageCluster)
            np.testing.assert_array_equal(other.tier.alive, port.tier.alive)
            assert [len(s) for s in other.tier.segments] == \
                [len(s) for s in port.tier.segments]
            got = other.search()
            for r in got.ranked:
                assert int(gids[0]) not in r.doc_ids.tolist()
            assert_parity(rother.search(), got)


def test_mutation_config_roundtrips():
    cfg = base_cfg(mutation=True, port=True, auto_compact_segments=4,
                   rebalance_skew=1.5)
    d = cfg.to_dict()
    cfg2 = PipelineConfig.from_dict(d)
    assert cfg2.mutation == cfg.mutation
    assert cfg2.mutation.active()
    assert RefConfig.from_dict(d).to_dict() == d
    argv = ["--mutation", "--auto-compact-segments", "4",
            "--auto-compact-dead-frac", "0.3", "--compact-interval-s", "0.5",
            "--rebalance-skew", "1.5"]
    cfg3 = PipelineConfig.from_cli(PipelineConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(argv))
    m = cfg3.mutation
    assert m.enabled and m.auto_compact_segments == 4
    assert m.auto_compact_dead_frac == 0.3
    assert m.compact_interval_s == 0.5 and m.rebalance_skew == 1.5
    ref3 = RefConfig.from_cli(RefConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(argv))
    assert cfg3.to_dict() == ref3.to_dict()
    assert not PipelineConfig().mutation.active()


def test_cli_builds_the_mutable_tier(capsys):
    """``--mutation`` on the CLI builds the mutable cluster and serves the
    corpus queries (the reference CI's ``--shards 2 --mutation``)."""
    from repro_torch.pipeline.__main__ import main
    main(["--docs", "300", "--queries", "4", "--mode", "espn", "--shards",
          "2", "--mutation", "--device", "cpu"])
    assert "mrr@10" in capsys.readouterr().out.lower()


def mid_churn(pipe, rng):
    """The reference test's mid-churn state, mixed: 6 docs ingested in two
    batches (each lands on the lightest shard, so both shards get a
    segment), two of them and two base docs tombstoned, shard 0 compacted
    (shard 1 keeps its segment). Returns the ingested ids."""
    gids = np.concatenate([pipe.ingest(*new_docs(rng, 3)) for _ in (0, 1)])
    pipe.delete(np.concatenate([gids[:2], [0, 7]]))
    pipe.compact(shard=0)
    return gids


def test_save_load_mutable_pipeline_mid_churn(tmp_path):
    """The reference's test on the port: a mutable cluster saved mid-churn
    writes ``mutation/`` (no ``shards/``), loads back with the same
    tombstones and segments, answers bit for bit as before, and goes on
    mutating from the grown doc-id space: an ingest on the loaded pipeline
    gives the ids the same ingest gives on the unsaved one."""
    ref, pipe = pair(mutation=True, cluster=True)
    ref.close()
    gids = mid_churn(pipe, np.random.default_rng(8))
    out = pipe.save(str(tmp_path / "art"))
    assert os.path.isdir(os.path.join(out, "mutation"))
    assert not os.path.isdir(os.path.join(out, "shards"))
    with pipe, Pipeline.load(out, device="cpu") as pipe2:
        assert isinstance(pipe2.tier, MutableStorageCluster)
        np.testing.assert_array_equal(pipe2.tier.alive, pipe.tier.alive)
        counts = [len(s) for s in pipe.tier.segments]
        assert [len(s) for s in pipe2.tier.segments] == counts
        assert counts[0] == 0 and sum(counts) == 1      # the mixed state
        a, b = pipe.search(), pipe2.search()
        assert_bitwise(a, b)
        assert a.breakdown.as_dict() == b.breakdown.as_dict()
        # the restored stack keeps mutating, as the unsaved one does
        cls, bows = new_docs(np.random.default_rng(9), 2)
        more = pipe.ingest(cls, bows)
        np.testing.assert_array_equal(pipe2.ingest(cls, bows), more)
        np.testing.assert_array_equal(more, gids[-1] + 1 + np.arange(2))
        for p in (pipe, pipe2):
            p.delete(more[:1])
        a, b = pipe.search(), pipe2.search()
        assert_bitwise(a, b)
        assert a.breakdown.as_dict() == b.breakdown.as_dict()
        assert pipe2.tier.stats["tombstones"] == 1
        for r in b.ranked:
            assert pipe2.tier.alive[r.doc_ids].all()


@pytest.mark.parametrize("mode", ["espn", "cascade"])
def test_save_and_load_of_a_mutable_tier_raise(tmp_path, mode):
    """The ``mutation/`` directory across the packages: after the same
    churn, the port writes the reference's files, fields, dtypes and
    values; the reference loads the port's directory and the port the
    reference's, and both answer, bill and go on mutating alike (in
    cascade the appended bit and FDE tables ride along)."""
    ref, port = pair(mode, mutation=True, cluster=True)
    with ref, port:
        both(ref, port, lambda p: mid_churn(p, np.random.default_rng(8)))
        rdir, pdir = (str(tmp_path / w) for w in ("ref", "port"))
        ref.save(rdir)
        port.save(pdir)
    for sub in ("", "mutation"):
        names = sorted(os.listdir(os.path.join(rdir, sub)))
        assert sorted(os.listdir(os.path.join(pdir, sub))) == names
        for name in names:
            if not name.endswith(".npz"):
                continue
            want, got = (np.load(os.path.join(d, sub, name))
                         for d in (rdir, pdir))
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                assert got[k].dtype == want[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name}:{k}")
    assert "shards" not in os.listdir(pdir)
    with RefPipeline.load(pdir) as r2, \
            Pipeline.load(rdir, device="cpu") as p2:
        assert isinstance(p2.tier, MutableStorageCluster)
        assert isinstance(r2.tier, RefMutable)
        np.testing.assert_array_equal(p2.tier.alive, r2.tier.alive)
        assert [len(s) for s in p2.tier.segments] == \
            [len(s) for s in r2.tier.segments]
        assert_parity(r2.search(), p2.search())
        cls, bows = new_docs(np.random.default_rng(9), 2)
        rg, gids = both(r2, p2, lambda p: p.ingest(cls, bows))
        np.testing.assert_array_equal(gids, rg)
        np.testing.assert_array_equal(gids, [406, 407])
        both(r2, p2, lambda p: p.delete(gids[:1]))
        got = p2.search()
        assert_parity(r2.search(), got)
        for r in got.ranked:
            assert int(gids[0]) not in r.doc_ids.tolist()
        assert p2.tier.stats == r2.tier.stats


def test_mutation_needs_the_mutable_tier():
    ref, port = pair(cluster=True)
    with ref, port:
        for call in (lambda: port.ingest(*new_docs(
                np.random.default_rng(0), 1)), lambda: port.delete([0]),
                port.compact, port.rebalance, port.maintain):
            with pytest.raises(RuntimeError, match="mutable tier"):
                call()


# -- segment plumbing -----------------------------------------------------------

def test_concat_and_merge_round_trip_rows():
    """The reference's round trip in the port, with the segment bytes (blob,
    offsets, token counts, checksums) equal across the packages."""
    c = corpus()
    lay = [ref_pack(c.cls[a:b], c.bow[a:b], checksum=True)
           for a, b in ((0, 50), (0, 20), (20, 50))]
    layout, a, b = (convert.layout_from_numpy(layout_arrays(x)) for x in lay)
    for p, r in zip((layout, a, b), lay):
        p.checksums = r.checksums.copy()
    cat = segments.concat_layouts([a, b])
    rcat = ref_segments.concat_layouts(lay[1:])
    assert cat.n_docs == 50
    for x, y in ((cat, layout), (cat, rcat)):
        np.testing.assert_array_equal(x.blob, y.blob)
        np.testing.assert_array_equal(x.offsets, y.offsets)
        np.testing.assert_array_equal(x.n_tokens, y.n_tokens)
        np.testing.assert_array_equal(x.checksums, y.checksums)
    for i in (0, 19, 20, 49):
        cls_w, bow_w = unpack_doc(layout, i)
        cls_g, bow_g = unpack_doc(cat, i)
        np.testing.assert_array_equal(cls_w, cls_g)
        np.testing.assert_array_equal(bow_w, bow_g)
    pieces = [(np.array([3, 5]), np.array([3, 5])),
              (np.array([0, 9]), np.array([20, 29]))]
    merged, gids = segments.merge_rows(
        [(x, r, g) for x, (r, g) in zip((a, b), pieces)], like=layout)
    rmerged, rgids = ref_segments.merge_rows(
        [(x, r, g) for x, (r, g) in zip(lay[1:], pieces)], like=lay[0])
    np.testing.assert_array_equal(gids, [3, 5, 20, 29])
    np.testing.assert_array_equal(gids, rgids)
    np.testing.assert_array_equal(merged.blob, rmerged.blob)
    np.testing.assert_array_equal(merged.offsets, rmerged.offsets)
    np.testing.assert_array_equal(merged.checksums, rmerged.checksums)
    for row, g in enumerate(gids):
        np.testing.assert_array_equal(unpack_doc(merged, row)[1],
                                      unpack_doc(layout, int(g))[1])
        np.testing.assert_array_equal(unpack_doc(merged, row)[1],
                                      ref_unpack(rmerged, row)[1])
    # an empty merge and a zero-doc concat keep the layout's shape
    empty, eg = segments.merge_rows([(a, np.zeros(0, np.int64),
                                      np.zeros(0, np.int64))], like=layout)
    assert empty.n_docs == 0 and len(eg) == 0
    assert empty.checksums is not None and empty.d_bow == layout.d_bow
    assert segments.concat_layouts([], like=layout).n_docs == 0


def test_concat_rejects_mismatched_layouts():
    c = corpus()
    a = pack(c.cls[:5], c.bow[:5])
    for other in (pack(c.cls[:5], c.bow[:5], dtype=np.float32),
                  pack(c.cls[:5], c.bow[:5], block=8192)):
        with pytest.raises(ValueError):
            segments.concat_layouts([a, other])


def test_scaled_ingest_packs_as_the_reference():
    """An int8 layout's per-doc scales: ``pack(scales=)`` stores the records
    divided by their scale, byte for byte as the reference, and decodes
    back through the scale."""
    c = corpus()
    sc = np.array([max(np.abs(c.cls[i]).max(), np.abs(c.bow[i]).max()) / 127
                   for i in range(20)], np.float32)
    kw = dict(dtype=np.int8, scales=sc)
    got, want = pack(c.cls[:20], c.bow[:20], **kw), \
        ref_pack(c.cls[:20], c.bow[:20], **kw)
    np.testing.assert_array_equal(got.blob, want.blob)
    np.testing.assert_array_equal(got.scales, want.scales)
    for i in (0, 7, 19):
        np.testing.assert_array_equal(unpack_doc(got, i)[1],
                                      ref_unpack(want, i)[1])


# -- ivf_add ----------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["fp32", "fp16", "int8"])
def test_ivf_add_matches_reference_and_plain_loop(quant):
    """``ivf_add`` on the reference's index: the same cells, slots, stored
    vectors and scales as the reference's loop, with the pad grown once
    (ids ``-1``, int8 scales ``1e-9``), and as the port's own sequential
    plain version."""
    c = corpus()
    ref = ref_build_ivf(c.cls, ncells=16, iters=4, quant=quant)
    arrays = index_arrays(ref)
    fast = convert.ivf_index_from_numpy(arrays, "cpu")
    plain = convert.ivf_index_from_numpy(arrays, "cpu")
    rng = np.random.default_rng(21)
    start = c.n_docs
    w0 = fast.max_cell
    # the first batch is crowded toward one centroid, so a cell overflows
    near = np.asarray(ref.centroids)[3] + 0.05 * rng.standard_normal(
        (2 * w0, c.cls.shape[1]))
    for vecs in (near.astype(np.float32),
                 new_docs(rng, 37)[0], new_docs(rng, 1)[0]):
        ids = np.arange(start, start + len(vecs))
        start += len(vecs)
        ref_ivf_add(ref, vecs, ids)
        ivf_add(fast, vecs, ids)
        ivf_add_plain(plain, vecs, ids)
    assert fast.max_cell > w0
    want = index_arrays(ref)
    for idx in (fast, plain):
        np.testing.assert_array_equal(idx.cell_ids.numpy(), want["cell_ids"])
        np.testing.assert_array_equal(idx.cell_vecs.numpy(),
                                      want["cell_vecs"])
        if quant == "int8":
            np.testing.assert_array_equal(idx.cell_scale.numpy(),
                                          want["cell_scale"])
            assert (idx.cell_scale[:, w0:][idx.cell_ids[:, w0:] < 0]
                    == 1e-9).all()
        np.testing.assert_array_equal(idx.cell_sizes, want["cell_sizes"])
        assert idx.n_docs == ref.n_docs == start
        assert idx.cell_ids.dtype == torch.int32


def test_ivf_add_empty_and_in_place():
    c = corpus()
    idx = build_ivf(c.cls, ncells=16, iters=4, device="cpu")
    ids0 = idx.cell_ids
    assert ivf_add(idx, np.zeros((0, c.cls.shape[1]), np.float32), []) \
        is idx
    assert idx.cell_ids is ids0
    out = ivf_add(idx, c.cls[:2], [400, 401])
    assert out is idx and idx.n_docs == 402
    assert (idx.cell_ids == 400).sum() == 1
    # the old tensors are untouched: a search holding them is undisturbed
    assert (ids0 == 400).sum() == 0


# -- the arena cache's invalidation ---------------------------------------------

def test_arena_cache_remove_gives_back_the_charge():
    """``remove`` gives back exactly what each insert charged (the
    reference's fp32 row size), so the evictions that follow, and every
    later clock, are the reference's."""
    d_cls, d_bow = 16, 8
    rng = np.random.default_rng(3)
    rows = {i: rng.standard_normal((int(rng.integers(1, 9)), d_bow))
            .astype(np.float16) for i in range(40)}
    budget = 4 * (d_cls + 8 * d_bow) * 12
    ours, ref = ArenaCache(budget, d_cls=d_cls), RefArenaCache(budget)
    for step in range(3):
        for i in range(step * 10, step * 10 + 16):
            r = rows[i]
            ours.put(i, r, len(r))
            ref.put(i, np.zeros(d_cls, np.float32), r.astype(np.float32),
                    len(r))
        drop = list(range(step * 10, step * 10 + 6, 2)) + [999]
        assert ours.remove(drop) == ref.remove(drop)
        assert ours.bytes_used == ref.bytes_used
        assert list(ours._lru) == list(ref._lru)
        assert ours.stats() == ref.stats()
    assert ours.evictions > 0


# -- churn: incremental == rebuild oracle ----------------------------------------

def rebuild_oracle(base_index, all_cls, all_bows, batches, alive, cfg):
    """The from-scratch stack, as the reference's test builds it: the
    pre-ingest index with every ingest batch replayed through ``ivf_add``,
    every doc ever seen packed anew (the side tables rebuilt from the grown
    layout), and the same tombstones on an immutable tier (its ``alive``
    attribute hook)."""
    start = len(all_cls) - sum(len(b[0]) for b in batches)
    for cls_b, _ in batches:
        ivf_add(base_index, cls_b, np.arange(start, start + len(cls_b)))
        start += len(cls_b)
    cfg = PipelineConfig.from_dict(cfg.to_dict())
    cfg.mutation, cfg.cluster = MutationConfig(), type(cfg.cluster)()
    oracle = Pipeline.from_artifacts(cfg, index=base_index,
                                     layout=_pack_layout(cfg, all_cls,
                                                         all_bows),
                                     device="cpu")
    oracle.tier.alive = alive.copy()
    return oracle


def churn(pipes, seed, compact_when, n_base):
    """The reference test's interleaving of ingests, deletes and
    compactions, applied alike to every pipeline in ``pipes``."""
    rng = np.random.default_rng(seed)
    batches, deleted = [], set()
    for step in range(2):
        docs = new_docs(rng, int(rng.integers(2, 6)))
        batches.append(docs)
        gids = [p.ingest(*docs) for p in pipes][0]
        kill = rng.random(len(gids)) < 0.3       # some ingested docs die too
        dead = set(gids[kill].tolist()) | set(
            rng.choice(n_base, int(rng.integers(1, 20)),
                       replace=False).tolist())
        dead -= deleted                          # never tombstone twice
        deleted |= dead
        for p in pipes:
            p.delete(sorted(dead))
        if compact_when == "mid" and step == 0:
            for p in pipes:
                p.compact()
    if compact_when == "end":
        for p in pipes:
            p.compact()
    return batches, deleted


def port_churn_vs_oracle(mode, compact_when, seed, layout_mode="ragged"):
    """The port alone: its own build, the churn, and its rebuild oracle;
    ids and scores bit for bit, no tombstoned id in any answer."""
    c = corpus()
    cfg = base_cfg(mode, mutation=True, cluster=True, port=True)
    if layout_mode == "fixed_stride":
        cfg.storage.layout_mode, cfg.storage.pool_k = "fixed_stride", 8
    with Pipeline.build(cfg, corpus=c, device="cpu") as pipe:
        batches, deleted = churn([pipe], seed, compact_when, c.n_docs)
        all_cls = np.concatenate([c.cls] + [b[0] for b in batches])
        all_bows = list(c.bow) + [bw for b in batches for bw in b[1]]
        base = build_ivf(c.cls, ncells=16, iters=cfg.index.iters,
                         quant=cfg.index.quant,
                         train_sample=cfg.index.train_sample, device="cpu")
        with rebuild_oracle(base, all_cls, all_bows, batches,
                            pipe.tier.alive, cfg) as oracle:
            want = oracle.search(*queries())
        got = pipe.search(*queries())
    assert_bitwise(want, got)
    for r in got.ranked:
        assert not set(r.doc_ids.tolist()) & deleted


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("compact_when", ["never", "mid", "end"])
@pytest.mark.parametrize("mode", CHURN_MODES)
def test_churn_matches_rebuild_oracle(mode, compact_when, seed):
    """Any interleaving of ingests, deletes and compactions ranks exactly
    like a stack rebuilt from scratch over the surviving docs: ids and
    scores bit for bit."""
    port_churn_vs_oracle(mode, compact_when, seed)


@pytest.mark.parametrize("compact_when", ["never", "end"])
def test_fixed_stride_churn_matches_rebuild_oracle(compact_when):
    """cspn on the pooled ``fixed_stride`` layout: ingested docs pool with
    the layout's ``pool_seed`` before they pack, so the grown layout equals
    a from-scratch pooled pack and the churned pipeline ranks as its
    rebuild bit for bit."""
    port_churn_vs_oracle("cspn", compact_when, 3, layout_mode="fixed_stride")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("compact_when", ["never", "mid", "end"])
@pytest.mark.parametrize("mode", CHURN_MODES)
def test_churn_matches_the_reference(mode, compact_when, seed):
    """The same churn on both packages, from the same artifacts: the same
    ids, bills, tombstones and counters, scores within ``SCORE_TOL``."""
    ref, port = pair(mode, mutation=True, cluster=True)
    with ref, port:
        _, deleted = churn([port, ref], seed, compact_when, corpus().n_docs)
        got = port.search(*queries())
        assert_parity(ref.search(*queries()), got)
        for r in got.ranked:
            assert not set(r.doc_ids.tolist()) & deleted
        np.testing.assert_array_equal(port.tier.alive, ref.tier.alive)
        assert port.tier.stats == ref.tier.stats


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000),
       mode=st.sampled_from(CHURN_MODES),
       compact_when=st.sampled_from(["never", "mid", "end"]))
def test_churn_property_port_alone(seed, mode, compact_when):
    """The churn oracle on the port, at drawn seeds (no deadline: one
    example builds two stacks)."""
    port_churn_vs_oracle(mode, compact_when, seed)
