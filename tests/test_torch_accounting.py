"""The reference's retrieval-accounting invariants
(``tests/test_retrieval_accounting.py``) pinned on the port, on the CPU, at
2,000 docs: truncated reads bill only the rows read, ``-1`` padding inside a
candidate row keeps ids and scores paired, empty batches answer empty in
every mode, and the latency and byte-bill contract holds in every mode, on
the single tier and on a 3-shard cluster.

Each case runs the reference and the port on the same artifacts (carried
across by ``repro_torch.convert``) and also holds the port's numbers to the
reference's: the same bills, the same counter deltas, the same rankings
(adjacent near-tie swaps within 1e-5 aside).
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same_ranking, index_arrays, layout_arrays,
                           port_tables)
from repro.core import rerank as ref_rerank
from repro.core.ivf import valid_candidates as ref_valid_candidates
from repro.core.prefetcher import ANNPrefetcher as RefPrefetcher
from repro.core.prefetcher import QueryResult as RefQueryResult
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.pipeline import RetrievalConfig as RefRetrieval
from repro.pipeline import StorageConfig as RefStorage
from repro.pipeline.config import ClusterConfig as RefClusterConfig
from repro_torch import convert
from repro_torch.core import rerank
from repro_torch.core.ivf import valid_candidates
from repro_torch.core.prefetcher import ANNPrefetcher, QueryResult
from repro_torch.pipeline import (Pipeline, PipelineConfig, available_backends,
                                  get_backend)
from repro_torch.pipeline.config import ClusterConfig

NEG = -1e30
MODES = sorted(available_backends())


class Env:
    """The reference test's ``base`` pipeline and the port's artifacts."""

    def __init__(self, corpus):
        cfg = RefConfig(storage=RefStorage(t_max=64),
                        retrieval=RefRetrieval(mode="espn", nprobe=16,
                                               k_candidates=50,
                                               prefetch_step=0.3))
        cfg.index.ncells = 32
        self.base = RefPipeline.build(cfg, corpus=corpus)
        self.corpus = corpus
        self.index = convert.ivf_index_from_numpy(
            index_arrays(self.base.index), "cpu")
        self.layout = convert.layout_from_numpy(
            layout_arrays(self.base.layout))

    def pipes(self, mode, n_shards=1, **retrieval):
        """Fresh reference and port pipelines for one mode (the port gets
        the reference's resident tables)."""
        d = self.base.cfg.to_dict()
        rcfg, pcfg = RefConfig.from_dict(d), PipelineConfig.from_dict(d)
        for cfg in (rcfg, pcfg):
            cfg.retrieval.mode = mode
            for k, v in retrieval.items():
                setattr(cfg.retrieval, k, v)
        rcfg.cluster = RefClusterConfig(n_shards=n_shards)
        pcfg.cluster = ClusterConfig(n_shards=n_shards)
        ref = RefPipeline.from_artifacts(rcfg, index=self.base.index,
                                         layout=self.base.layout,
                                         corpus=self.corpus)
        port = Pipeline.from_artifacts(pcfg, index=self.index,
                                       layout=self.layout,
                                       corpus=self.corpus, device="cpu",
                                       **port_tables(ref))
        return ref, port


@pytest.fixture(scope="module")
def env(small_corpus):
    e = Env(small_corpus)
    yield e
    e.base.close()


def queries(c, n=6):
    return c.queries_cls[:n], c.queries_bow[:n], c.query_lens[:n]


def assert_parity(want, got):
    assert len(want.ranked) == len(got.ranked)
    for x, y in zip(want.ranked, got.ranked):
        assert (y.n_reranked, y.bow_bytes_read) == (x.n_reranked,
                                                    x.bow_bytes_read)
        assert_same_ranking(x, y)
    assert got.breakdown.as_dict() == want.breakdown.as_dict()


def deltas(tier, before):
    return {k: tier.stats[k] - before[k] for k in before}


# -- truncated-read miss accounting ------------------------------------------

def test_from_read_counts_only_rows_actually_read(env):
    """Partial re-rank reads fin[:rr]: the stats bill rr misses and the
    miss arena holds rr rows, not len(doc_ids); reranked through the
    positional miss rows, the answer is the reference's."""
    ref, port = env.pipes("gds")
    with ref, port:
        ids = np.arange(10)
        scores = np.linspace(1, 0.1, 10).astype(np.float32)
        read, rread = port.tier.read(ids[:4]), ref.tier.read(ids[:4])
        qr = QueryResult.from_read(ids, scores, read, ann_s=0.0)
        rqr = RefQueryResult.from_read(ids, scores, rread, ann_s=0.0)
        assert vars(qr.stats) == vars(rqr.stats) and qr.stats.n_misses == 4
        assert len(qr.miss_buffers.lens) == len(rqr.miss_buffers[0]) == 4
        assert len(qr.doc_ids) == 10
        q = env.corpus.queries_bow[0], int(env.corpus.query_lens[0])
        out = rerank.rerank_query(*q, qr, rerank_count=4,
                                  doc_bytes=port.backend.doc_bytes)
        want = ref_rerank.rerank_query(*q, rqr, rerank_count=4,
                                       doc_bytes=ref.backend.doc_bytes)
        assert (out.n_reranked, out.bow_bytes_read) == (
            want.n_reranked, want.bow_bytes_read)
        assert_same_ranking(want, out)
        assert out.n_reranked == 4


def test_direct_backend_truncated_read_stats(env):
    """rerank_count < k_candidates requests (and bills) only what the
    re-rank consumes; the tier's counter deltas are the reference's."""
    ref, port = env.pipes("gds", rerank_count=4)
    with ref, port:
        b0, rb0 = dict(port.tier.stats), dict(ref.tier.stats)
        got = port.search(*queries(env.corpus, 3))
        want = ref.search(*queries(env.corpus, 3))
        d = deltas(port.tier, b0)
        assert d["doc_requests"] == 3 * 4 and d["docs"] <= 3 * 4
        assert d == deltas(ref.tier, rb0)
        assert all(r.n_reranked == 4 for r in got.ranked)
        assert_parity(want, got)


# -- candidate score/id alignment under -1 padding ---------------------------

def test_valid_candidates_interleaved_padding():
    ids = np.array([7, -1, 3, -1, 9])
    scores = np.array([0.9, NEG, 0.5, NEG, 0.4], np.float32)
    fin, s = valid_candidates(ids, scores)
    rfin, rs = ref_valid_candidates(ids, scores)
    np.testing.assert_array_equal(fin, [7, 3, 9])
    np.testing.assert_array_equal(fin, rfin)
    np.testing.assert_array_equal(s, rs)


@pytest.mark.parametrize("mode", ["gds", "bitvec", "fde"])
def test_backend_scores_survive_interleaved_padding(env, monkeypatch, mode):
    """A -1 inside the candidate row (not a pure suffix) must not shift
    every later candidate onto its neighbour's score, in either
    package."""
    import repro.pipeline.backends as RB
    import repro_torch.pipeline.backends as B

    t0, t1 = 5, 11
    row_ids = np.array([[t0, -1, t1]], np.int64)
    row_s = np.array([[0.9, NEG, 0.5]], np.float32)

    def ref_search(index, q, nprobe, k):
        b = np.asarray(q).shape[0]
        return np.tile(row_s, (b, 1)), np.tile(row_ids, (b, 1))

    def port_search(index, q, nprobe, k):
        b = np.asarray(q).shape[0]
        return (torch.from_numpy(np.tile(row_s, (b, 1))),
                torch.from_numpy(np.tile(row_ids, (b, 1))))

    monkeypatch.setattr(RB, "search", ref_search)
    monkeypatch.setattr(B, "search", port_search)
    # fde only consults ``search`` on its IVF path, taken when n_docs
    # EXCEEDS the brute threshold: zero forces it for any corpus
    kw = {"fde_brute_threshold": 0} if mode == "fde" else {}
    ref, port = env.pipes(mode, **kw)
    with ref, port:
        got = port.search(*queries(env.corpus, 1))
        want = ref.search(*queries(env.corpus, 1))
    out = got.ranked[0]
    assert len(out.doc_ids) == 2 and set(out.doc_ids.tolist()) == {t0, t1}
    assert (out.scores > -1e20).all()
    assert_parity(want, got)


def test_prefetcher_scores_survive_interleaved_padding(env, monkeypatch):
    import repro.core.prefetcher as RP
    import repro_torch.core.prefetcher as P

    ids = np.array([[5, -1, 11]], np.int64)
    scores = np.array([[0.9, NEG, 0.5]], np.float32)

    def ref_two_phase(index, q, nprobe, k, delta):
        return (scores, ids), (scores, ids), None

    def port_two_phase(index, q, nprobe, k, delta):
        t = (torch.from_numpy(scores), torch.from_numpy(ids))
        return t, t, None

    monkeypatch.setattr(RP, "search_two_phase", ref_two_phase)
    monkeypatch.setattr(P, "search_two_phase", port_two_phase)
    ref, port = env.pipes("espn")
    with ref, port:
        q = env.corpus.queries_cls[:1]
        (res,) = ANNPrefetcher(port.index, port.tier,
                               prefetch_step=0.3).run_batch(q, nprobe=4, k=3)
        (rres,) = RefPrefetcher(ref.index, ref.tier,
                                prefetch_step=0.3).run_batch(q, nprobe=4,
                                                             k=3)
    np.testing.assert_array_equal(res.doc_ids, [5, 11])
    np.testing.assert_array_equal(res.doc_ids, rres.doc_ids)
    np.testing.assert_array_equal(res.cand_scores, rres.cand_scores)
    assert vars(res.stats) == vars(rres.stats)


# -- empty query batches ------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_empty_batch_returns_empty_response(env, mode):
    """A batch of no queries answers an empty ranking with a finite bill
    in every mode; the bill is the reference's."""
    c = env.corpus
    empty = (np.zeros((0, c.queries_cls.shape[1]), np.float32),
             np.zeros((0,) + c.queries_bow.shape[1:], np.float32),
             np.zeros((0,), np.int32))
    ref, port = env.pipes(mode)
    with ref, port:
        got = port.search(*empty)
        want = ref.search(*empty)
    assert got.ranked == []
    assert np.isfinite(got.breakdown.hit_rate)
    assert np.isfinite(got.breakdown.total_s)
    assert got.breakdown.as_dict() == want.breakdown.as_dict()


# -- latency / memory invariants across every registered backend --------------

@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_latency_accounting_invariants(env, mode, n_shards):
    """total_s is exactly the sum of its stage terms (+ the fixed 0.2 ms
    overhead), bytes_read bills the batch's unique bytes (per-query bills
    minus the coalescing engine's dedup savings), the tier's request
    counter matches what the re-rank consumed, and the resident tables
    are billed only to the backends that need them: on the single tier
    and on a 3-shard cluster, with the reference's bills and counters."""
    ref, port = env.pipes(mode, n_shards=n_shards)
    with ref, port:
        b0, rb0 = dict(port.tier.stats), dict(ref.tier.stats)
        resp = port.search(*queries(env.corpus))
        want = ref.search(*queries(env.corpus))
        d, rd = deltas(port.tier, b0), deltas(ref.tier, rb0)
        bits, fde = port.tier.bits, port.tier.fde
    bd = resp.breakdown
    assert bd.total_s == pytest.approx(
        bd.encode_s + bd.ann_s + bd.critical_io_s + bd.rerank_s + 0.2e-3)
    assert bd.dedup_bytes_saved >= 0
    assert bd.bytes_read + bd.dedup_bytes_saved == sum(
        r.bow_bytes_read for r in resp.ranked)
    assert 0.0 <= bd.hit_rate <= 1.0
    reranked = sum(r.n_reranked for r in resp.ranked)
    assert d["docs"] <= d["doc_requests"]
    if mode == "espn":
        assert d["doc_requests"] >= reranked
    else:
        assert d["doc_requests"] == reranked
    cls_ = get_backend(mode)
    assert (bits is not None) == cls_.needs_bit_table
    assert (fde is not None) == cls_.needs_fde_table
    assert_parity(want, resp)
    assert d == rd


# -- the same invariants on a mutated (segmented + tombstoned) tier -----------

def churn_both(ref, port, corpus):
    """The reference test's churn, alike on both: two ingest segments of
    12 docs live, 40 base docs tombstoned, nothing compacted."""
    rng = np.random.default_rng(11)
    for _ in range(2):
        cls = rng.standard_normal((12, port.layout.d_cls)).astype(np.float32)
        cls /= np.linalg.norm(cls, axis=1, keepdims=True)
        bows = [rng.standard_normal((int(rng.integers(4, 12)),
                                     port.layout.d_bow)).astype(np.float32)
                for _ in range(12)]
        for p in (ref, port):
            p.ingest(cls, bows)
    dead = rng.choice(corpus.n_docs, 40, replace=False)
    for p in (ref, port):
        p.delete(dead)


def mutable_pair(env, mode="espn"):
    """Both packages' mutable espn pipelines on the same artifacts (each
    with its own index object: ``ingest`` grows it in place)."""
    import dataclasses
    d = env.base.cfg.to_dict()
    rcfg, pcfg = RefConfig.from_dict(d), PipelineConfig.from_dict(d)
    for cfg in (rcfg, pcfg):
        cfg.retrieval.mode = mode
        cfg.mutation.enabled = True
    ref = RefPipeline.from_artifacts(
        rcfg, index=dataclasses.replace(env.base.index),
        layout=env.base.layout, corpus=env.corpus)
    port = Pipeline.from_artifacts(
        pcfg, index=convert.ivf_index_from_numpy(
            index_arrays(env.base.index), "cpu"),
        layout=env.layout, corpus=env.corpus, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def churned(env):
    """A mutable pipeline mid-churn in both packages: the worst case for
    accounting (tests/test_retrieval_accounting.py's ``churned``)."""
    ref, port = mutable_pair(env)
    churn_both(ref, port, env.corpus)
    yield ref, port
    ref.close()
    port.close()


def in_mode(pipes, mode):
    """Both churned pipelines in ``mode``: the reference's ``with_mode``,
    and the port's over the same segments and tombstones with the
    reference's resident tables (built from the grown layout)."""
    ref, port = pipes
    if mode == "espn":
        return ref, port
    rother = ref.with_mode(mode)
    cfg = PipelineConfig.from_dict(port.cfg.to_dict())
    cfg.retrieval.mode = mode
    t = port.tier
    other = Pipeline._assemble(
        cfg, port.corpus, port.index, port.layout,
        shard_layouts=list(zip((sh.layout for sh in t.shards), t.shard_ids)),
        segments=[list(s) for s in t.segments], alive=t.alive,
        **port_tables(rother))
    return rother, other


@pytest.mark.parametrize("mode", MODES)
def test_segment_accounting_invariants(churned, mode):
    """Segment reads (extra device transactions) and tombstone masking keep
    the latency-sum, byte-bill and request-count contracts of every
    backend, no dead id reaches a result, and the bills and counter deltas
    are the reference's."""
    ref, pipe = in_mode(churned, mode)
    c = pipe.corpus
    try:
        before, rbefore = dict(pipe.tier.stats), dict(ref.tier.stats)
        resp = pipe.search(*queries(c))
        want = ref.search(*queries(c))
        d, rd = deltas(pipe.tier, before), deltas(ref.tier, rbefore)
    finally:
        if mode != "espn":
            ref.close()
            pipe.close()
    bd = resp.breakdown
    assert bd.total_s == pytest.approx(
        bd.encode_s + bd.ann_s + bd.critical_io_s + bd.rerank_s + 0.2e-3)
    assert bd.dedup_bytes_saved >= 0
    assert bd.bytes_read + bd.dedup_bytes_saved == sum(
        r.bow_bytes_read for r in resp.ranked)
    reranked = sum(r.n_reranked for r in resp.ranked)
    assert d["docs"] <= d["doc_requests"]
    if mode == "espn":
        assert d["doc_requests"] >= reranked
    else:
        assert d["doc_requests"] == reranked
    alive = pipe.tier.alive
    for r in resp.ranked:
        assert (r.doc_ids >= 0).all()
        assert alive[r.doc_ids].all()
    assert_parity(want, resp)
    assert d == rd


def test_server_mutation_counters_equal_the_reference(env):
    """``RetrievalServer`` over a churning pipeline: ingests, deletes, a
    compaction and a rebalance between server batches; the summary's
    mutation counters (measured from server start) and every answer are
    the reference server's."""
    from repro.serve.scheduler import BatchPolicy as RefBatchPolicy
    from repro_torch.serve.scheduler import BatchPolicy
    ref, port = mutable_pair(env, "gds")
    c = env.corpus
    qs = [(c.queries_cls[i], c.queries_bow[i], int(c.query_lens[i]))
          for i in range(8)]
    servers = [ref.serve(RefBatchPolicy(max_batch=8, max_wait_s=5.0)),
               port.serve(BatchPolicy(max_batch=8, max_wait_s=5.0))]
    try:
        rng = np.random.default_rng(5)
        answers = []
        for step in range(3):
            reqs = [[srv.query_async(*q) for q in qs] for srv in servers]
            for rs in reqs:
                for r in rs:
                    assert r.done.wait(60.0) and r.error is None
            answers.append(reqs)
            cls = rng.standard_normal((5, port.layout.d_cls)).astype(
                np.float32)
            bows = [rng.standard_normal((6, port.layout.d_bow)).astype(
                np.float32) for _ in range(5)]
            dead = [int(x) for x in rng.choice(c.n_docs, 7, replace=False)
                    if port.tier.alive[x]]
            for p in (ref, port):
                p.ingest(cls, bows)
                p.delete(dead)
                if step == 1:
                    p.compact()
                    p.rebalance()
    finally:
        for srv in servers:
            srv.shutdown()
    s, rs = servers[1].stats.summary(), servers[0].stats.summary()
    assert s["mutation"] == rs["mutation"]
    assert s["mutation"]["ingests"] == 2 and s["mutation"]["tombstones"] > 0
    assert s["mutation"]["compactions"] == 1
    for rreqs, preqs in answers:
        for w, g in zip(rreqs, preqs):
            assert_same_ranking(w.result, g.result)
    ref.close()
    port.close()
