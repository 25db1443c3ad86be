"""The port's observability layer against the JAX reference, on the CPU:
streaming histograms and the metrics exposition give the reference's
numbers and text; a traced batch gives the reference's span tree (names,
categories, parents, query ids and simulated seconds; wall times differ by
nature) in every single-tier mode, faulted or not; tracing changes no id,
score or bill; and the Perfetto export loads in both packages' analyzers.
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_parity import (artifacts, configs, index_arrays, layout_arrays,
                           port_tables)
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import StreamingHistogram as RefHistogram
from repro.obs import analyze_trace as ref_analyze_trace
from repro.pipeline import Pipeline as RefPipeline
from repro.serve.engine import ServeStats as RefServeStats
from repro.storage import faults as ref_faults
from repro_torch import convert
from repro_torch.core.espn import ESPNRetriever
from repro_torch.core.ivf import search_two_phase, valid_candidates
from repro_torch.obs import (MetricsRegistry, Span, StreamingHistogram,
                             Tracer, analyze_trace)
from repro_torch.obs.analyze import (WORK_SPANS, dominant_stage,
                                     host_breakdown)
from repro_torch.pipeline import Pipeline
from repro_torch.serve.engine import RetrievalServer, ServeStats
from repro_torch.storage import faults

MODES = ("espn", "gds", "mmap", "swap", "dram", "bitvec", "fde", "cascade",
         "cspn")
FAULTS = dict(read_error_rate=0.3, stall_rate=0.4, corruption_rate=0.5,
              checksum=True, read_retries=1, seed=4)


# -- metrics -------------------------------------------------------------------

def lognormal(n, seed=7):
    return np.exp(np.random.default_rng(seed).normal(2.0, 1.5, size=n))


def test_histogram_equals_the_reference():
    xs = np.concatenate([lognormal(5000), [0.0, -1.0]])
    ours, ref = StreamingHistogram(), RefHistogram()
    ours.extend(xs)
    ref.extend(xs)
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert ours.percentile(p) == ref.percentile(p), p
    assert (ours.min, ours.max, ours.mean(), len(ours)) == (
        ref.min, ref.max, ref.mean(), len(ref))
    assert ours.cumulative_buckets() == ref.cumulative_buckets()
    # and both track the exact percentile to the bucket resolution
    assert ours.percentile(99) == pytest.approx(
        float(np.percentile(xs, 99)), rel=0.05)
    a, b = StreamingHistogram(), StreamingHistogram()
    a.extend([1.0, 2.0])
    with pytest.raises(ValueError):
        a.merge(StreamingHistogram(growth=1.1))
    assert len(a.merge(b)) == 2


def fill_registry(reg):
    reg.counter("reads_total", help="total reads").inc(3)
    reg.gauge("depth").set(7.5)
    reg.histogram("lat_ms").extend(lognormal(300, seed=1))
    reg.register_source("tier", lambda: {"blocks": 11, "ok": True,
                                         "skipme": "not-a-number"})

    def dying():
        raise RuntimeError("snapshot failed")
    reg.register_source("bad", dying)
    return reg.expose()


def test_registry_exposition_equals_the_reference():
    text = fill_registry(MetricsRegistry())
    assert text == fill_registry(RefRegistry())
    assert "tier_blocks 11" in text and "skipme" not in text
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")


def test_serve_stats_exposition_equals_the_reference():
    xs = lognormal(500, seed=3)
    out = []
    for stats in (ServeStats(), RefServeStats()):
        for x in xs:
            stats.latencies_ms.append(float(x))
            stats.sim_latencies_ms.append(float(x) * 0.5)
            stats.slo_latencies_ms.append(float(x) * 1.5)
        stats.batch_sizes.extend([4, 8, 8])
        stats.offered, stats.served_in_slo, stats.shed = 500, 480, 20
        stats.degraded, stats.retries = 3, 7
        stats.tenant("tight").offered = 500
        out.append((stats.summary(), stats.expose()))
    assert out[0] == out[1]


def test_dominant_stage_equals_the_reference():
    from repro.obs.analyze import dominant_stage as ref_dominant
    stages = {"queue": 1.0, "critical_io": 9.0, "rerank": 2.0}
    for flags in (None, {"retries": 2}, {"repairs": 1},
                  {"hedged": 3, "hedge_wins": 0}):
        assert dominant_stage(stages, flags) == ref_dominant(stages, flags)
    assert dominant_stage({"queue": 5.0, "critical_io": 1.0}) == "queue"


# -- span trees -------------------------------------------------------------------

def traced_both(mode, fault_kw):
    """One batch through each package with a tracer attached (cfg.obs),
    and the spans, responses and tier counters."""
    c, index, layout = artifacts()
    ref_cfg, port_cfg = configs(mode)
    for cfg, fl in ((ref_cfg, ref_faults), (port_cfg, faults)):
        cfg.obs.trace = True
        if fault_kw:
            cfg.faults = fl.FaultConfig(**fault_kw)
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        r = ref.search(*q)
        r_spans = ref.tracer.spans()
        tables = port_tables(ref)
    with Pipeline.from_artifacts(
            port_cfg, index=convert.ivf_index_from_numpy(
                index_arrays(index), "cpu"),
            layout=convert.layout_from_numpy(layout_arrays(layout)),
            device="cpu", **tables) as port:
        assert port.tracer is port.tier.tracer is not None
        p = port.search(*q)
        p_spans = port.tracer.spans()
        assert port.tracer.open_count() == 0
    return r, p, r_spans, p_spans


def tree(spans):
    """Each span as (name, category, parent's position, query id,
    simulated seconds, its storage-side args): no wall times."""
    pos = {s.sid: i for i, s in enumerate(spans)}
    keep = ("n_unique", "n_blocks", "failed", "count", "mode", "n_queries",
            "hit_rate", "n_candidates", "serial")
    return [(s.name, s.cat, pos.get(s.parent), s.qid, s.sim_s,
             {k: s.args[k] for k in keep if k in s.args}) for s in spans]


def without_host(spans):
    """The spans less the port's ``cat="host"`` ones (wall time of host
    work, which the reference does not trace), each child of a dropped span
    re-parented to its nearest kept ancestor."""
    by_sid = {s.sid: s for s in spans}

    def kept(sid):
        while sid is not None and by_sid[sid].cat == "host":
            sid = by_sid[sid].parent
        return sid
    return [dataclasses.replace(s, parent=kept(s.parent)) for s in spans
            if s.cat != "host"]


def assert_nested(spans):
    """Every span's wall interval lies inside its parent's."""
    by_sid = {s.sid: s for s in spans}
    for s in spans:
        if s.parent is not None:
            par = by_sid[s.parent]
            assert par.t0 <= s.t0 and s.t1 <= par.t1, (s.name, par.name)


@pytest.mark.parametrize("fault_kw", [None, FAULTS], ids=["plain", "faulted"])
@pytest.mark.parametrize("mode", MODES)
def test_span_tree_equals_the_reference(mode, fault_kw):
    r, p, r_spans, p_spans = traced_both(mode, fault_kw)
    assert tree(without_host(p_spans)) == tree(r_spans)
    assert p.breakdown.as_dict() == r.breakdown.as_dict()
    # the per-query spans reconcile with the batch breakdown
    bd = p.breakdown
    assert sum(s.sim_s for s in p_spans if s.name == "critical_io") == \
        pytest.approx(bd.critical_io_s, abs=1e-12)
    assert sum(s.sim_s for s in p_spans if s.name in ("rerank",
                                                     "bit_filter")) == \
        pytest.approx(bd.rerank_s, abs=1e-12)
    assert_nested(p_spans)
    if fault_kw is None:
        assert not any(s.cat == "fault" for s in p_spans)


@pytest.mark.parametrize("mode", MODES)
def test_tracing_is_bitwise_invisible(mode):
    c, index, layout = artifacts()
    out = []
    for trace in (False, True):
        _, cfg = configs(mode)
        cfg.obs.trace = trace
        cfg.faults = faults.FaultConfig(**FAULTS)
        with Pipeline.from_artifacts(
                cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(layout)),
                device="cpu") as pipe:
            assert (pipe.tracer is not None) == trace
            out.append((pipe.search(c.queries_cls, c.queries_bow,
                                    c.query_lens), dict(pipe.tier.stats)))
    (a, a_stats), (b, b_stats) = out
    for x, y in zip(a.ranked, b.ranked):
        np.testing.assert_array_equal(x.doc_ids, y.doc_ids)
        np.testing.assert_array_equal(x.scores, y.scores)
        assert x.degraded == y.degraded
    assert a.breakdown.as_dict() == b.breakdown.as_dict()
    assert a_stats == b_stats


# -- host spans -------------------------------------------------------------------

def port_pipeline(mode, trace=True):
    c, index, layout = artifacts()
    _, cfg = configs(mode)
    cfg.obs.trace = trace
    return Pipeline.from_artifacts(
        cfg, index=convert.ivf_index_from_numpy(index_arrays(index), "cpu"),
        layout=convert.layout_from_numpy(layout_arrays(layout)),
        device="cpu")


def traced_port(mode):
    """One traced batch through the port: the response, the spans and
    every coalesced read the tier made."""
    c, _, _ = artifacts()
    with port_pipeline(mode) as pipe:
        reads = []
        read_batch = pipe.tier.read_batch

        def kept(*a, **kw):
            res = read_batch(*a, **kw)
            reads.append(res)
            return res
        pipe.tier.read_batch = kept
        resp = pipe.search(c.queries_cls, c.queries_bow, c.query_lens)
        assert pipe.tracer.open_count() == 0
        return pipe, resp, pipe.tracer.spans(), reads


def prefetch_recount(pipe, q_cls):
    """The prefetcher's hit masks and reuse check counted anew: the
    two-phase search's lists, each query's misses, and the misses that any
    query's prefetch list (the prefetch read's arena) holds."""
    cfg = pipe.cfg.retrieval
    pf = pipe.backend.prefetcher
    approx, final, _ = search_two_phase(pipe.index, q_cls, cfg.nprobe,
                                        cfg.k_candidates,
                                        pf.delta(cfg.nprobe))
    a_ids = approx[1].numpy()
    f_scores, f_ids = (t.numpy() for t in final)
    prefs = [a[a >= 0] for a in a_ids]
    arena = set(np.concatenate(prefs).tolist())
    n = dict(n_candidates=0, n_hits=0, n_misses=0, n_served=0)
    for b, pref in enumerate(prefs):
        fin, _ = valid_candidates(f_ids[b], f_scores[b])
        hit = np.isin(fin, pref)
        n["n_candidates"] += len(fin)
        n["n_hits"] += int(hit.sum())
        n["n_misses"] += int((~hit).sum())
        n["n_served"] += sum(int(i) in arena for i in fin[~hit])
    return n


@pytest.mark.parametrize("mode", ["espn", "gds"])
def test_host_spans_time_the_batch(mode):
    """Each host span opens inside the batch's ``query_batch``, on its
    thread, as often as the table of spans says, with its counters; the
    per-query ``rerank`` span is the wall of the ``rerank_query`` call."""
    c, _, _ = artifacts()
    pipe, resp, spans, reads = traced_port(mode)
    assert_nested(spans)
    (qb,) = [s for s in spans if s.name == "query_batch"]
    host = [s for s in spans if s.cat == "host"]
    assert {s.name for s in host} <= set(WORK_SPANS)
    for s in host + [s for s in spans if s.name in ("plan", "read_batch")]:
        assert qb.t0 <= s.t0 <= s.t1 <= qb.t1 and s.tid == qb.tid, s.name
    named = {n: [s for s in host if s.name == n] for n in WORK_SPANS}
    B = len(c.query_lens)
    assert len(named["ivf_search"]) == 1
    (cand,) = [s for s in spans if s.name == "candidate_gen"]
    assert named["ivf_search"][0].parent == cand.sid
    if mode == "espn":
        for n in ("hit_masks", "reuse_check", "views"):
            assert len(named[n]) == 1, n
            assert named[n][0].parent == cand.sid
        assert named["views"][0].args["n_queries"] == B
        got = {**named["hit_masks"][0].args, **named["reuse_check"][0].args}
        assert got == prefetch_recount(pipe, c.queries_cls)
    else:
        assert not named["hit_masks"] and not named["reuse_check"]
        assert [s.args["n_queries"] for s in named["views"]] == [1] * B
    # one wall rerank span a scored query, holding its byte bill, its
    # lookup and its scoring (every reranked doc scored)
    scored = [b for b, out in enumerate(resp.ranked) if not out.degraded]
    reranks = [s for s in spans if s.name == "rerank"]
    assert [s.qid for s in reranks] == scored
    assert len(named["score"]) == len(scored)
    for s in reranks:
        assert s.t1 > s.t0 and s.sim_s > 0
        within = [h for h in host if s.t0 <= h.t0 and h.t1 <= s.t1]
        names = [h.name for h in within if h.name != "io_wait"]
        assert names == ["bill", "lookup", "score"]
        assert within[-1].args["n_docs"] == resp.ranked[s.qid].n_reranked
    # every staged run waited on and copied once, under an io_wait span
    runs = sum(len(r.plan.runs) for r in reads if r.coalesced)
    staged = sum(r._staging.numel() * r._staging.element_size()
                 for r in reads if r.coalesced and r._staging is not None)
    assert sum(s.args["n_runs"] for s in named["io_wait"]) == runs > 0
    assert sum(s.args["bytes"] for s in named["io_wait"]) == staged > 0
    assert named["bill"]
    hb = host_breakdown(spans)
    assert hb["n_batches"] == 1 and hb["query_batch_s"] == qb.wall_s
    assert 0.0 <= hb["untraced_s"] <= hb["query_batch_s"]
    for n in WORK_SPANS:
        assert hb["spans"][n] == len(named[n]) or n in ("plan", "read_batch")
        assert 0.0 <= hb["work_s"][n] <= qb.wall_s
    assert hb["spans"]["read_batch"] == len(reads)
    if mode == "espn":
        assert hb["counters"]["reuse_check"]["n_served"] == \
            prefetch_recount(pipe, c.queries_cls)["n_served"]


def test_host_breakdown_counts_the_batches_own_thread():
    """``host_breakdown`` takes each batch's own thread's work spans, counts
    nested spans of one name once, and leaves what no work span covers
    as untraced."""
    tr = Tracer(clock=iter([0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0,
                            6.0]).__next__)
    qb = tr.begin("query_batch")
    a = tr.begin("views", cat="host", n_queries=4)
    b = tr.begin("views", cat="host", n_queries=1)
    tr.end(b)
    tr.end(a)
    tr.end(tr.begin("bill", cat="host"))
    tr.end(qb)
    other = Span(-1, None, "score", "host", None, 0.5, 5.0, tid=qb.tid + 1)
    spans = tr.spans() + [other]
    hb = host_breakdown(spans)
    assert hb["n_batches"] == 1 and hb["query_batch_s"] == 6.0
    assert hb["work_s"]["views"] == 2.0 and hb["work_s"]["bill"] == 1.0
    assert hb["work_s"]["score"] == 0.0
    assert hb["spans"]["views"] == 2
    assert hb["counters"]["views"] == {"n_queries": 5}
    assert hb["untraced_s"] == 3.0


def test_attach_tracer_reaches_the_whole_stack():
    """One ``attach_tracer`` call reaches the backend, the prefetcher and
    the storage tier (and a traced read's waits); ``None`` detaches all
    three. The server and ``ESPNRetriever`` attach through it."""
    c, _, _ = artifacts()
    q = (c.queries_cls[:4], c.queries_bow[:4], c.query_lens[:4])
    with port_pipeline("espn", trace=False) as pipe:
        stack = (pipe.backend, pipe.backend.prefetcher, pipe.tier)
        assert pipe.tracer is None
        tr = Tracer()
        pipe.attach_tracer(tr)
        assert all(x.tracer is tr for x in stack) and pipe.tracer is tr
        pipe.search(*q)
        names = {s.name for s in tr.spans()}
        assert {"query_batch", "plan", "hit_masks", "io_wait"} <= names
        pipe.attach_tracer(None)
        assert all(x.tracer is None for x in stack) and pipe.tracer is None
        n = len(tr.spans())
        pipe.search(*q)
        assert len(tr.spans()) == n
        srv = RetrievalServer(pipe.backend, tracer=Tracer())
        try:
            assert all(x.tracer is srv.tracer for x in stack)
        finally:
            srv.shutdown()
        ret = ESPNRetriever(pipe.index, pipe.tier,
                            pipe.cfg.retrieval.to_espn_config())
        ret.tracer = tr
        assert ret.backend.prefetcher.tracer is tr is pipe.tier.tracer
        ret.attach_tracer(None)
        assert ret.tracer is ret.backend.prefetcher.tracer is None


def test_query_sims_are_the_spans_sums():
    """``query_sims`` (kept as spans are recorded) equals a scan of the
    spans, by query and name."""
    _, _, spans, _ = traced_port("espn")
    tr = Tracer()
    for s in spans:
        if s.closed:
            tr.add(s.name, s.cat, s.qid, t0=s.t0, t1=s.t1, sim_s=s.sim_s)
    sp = tr.begin("request", qid=0)
    tr.end(sp, sim_s=0.25)
    for qid in {s.qid for s in tr.spans()}:
        want = {}
        for s in tr.spans():
            if s.qid == qid:
                want[s.name] = want.get(s.name, 0.0) + s.sim_s
        assert tr.query_sims(qid) == pytest.approx(want, abs=0, rel=1e-12)
        assert tr.query_sims(qid, names=("rerank",)) == {
            k: v for k, v in want.items() if k == "rerank"}
    assert tr.query_sims(0)["request"] == 0.25
    assert tr.query_sims("none") == {}


# -- exports --------------------------------------------------------------------

def test_perfetto_export_and_metrics_text(tmp_path):
    """A traced server run exports Perfetto JSON that both packages'
    analyzers read alike; the pipeline's metrics text is the
    reference's for the same reads."""
    c, index, layout = artifacts()
    ref_cfg, port_cfg = configs("gds")
    for cfg, fl in ((ref_cfg, ref_faults), (port_cfg, faults)):
        cfg.faults = fl.FaultConfig(**FAULTS)
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        ref.search(*q)
        want_text = ref.metrics_text()
    with Pipeline.from_artifacts(
            port_cfg, index=convert.ivf_index_from_numpy(
                index_arrays(index), "cpu"),
            layout=convert.layout_from_numpy(layout_arrays(layout)),
            device="cpu") as pipe:
        pipe.search(*q)
        assert pipe.metrics_text() == want_text
        with pytest.raises(RuntimeError, match="no tracer attached"):
            pipe.export_trace(str(tmp_path / "none.json"))
        path = str(tmp_path / "serve.json")
        pipe.cfg.serve.slo_ms = 0.25     # far below the device bill: every
        pipe.cfg.serve.shed = False      # request violates, none shed
        srv = pipe.serve(policy=None, trace_path=path)
        try:
            reqs = [srv.query_async(c.queries_cls[i], c.queries_bow[i],
                                    int(c.query_lens[i])) for i in range(8)]
            for r in reqs:
                assert r.done.wait(30)
        finally:
            srv.shutdown()                # exports the trace
        assert srv.tracer is pipe.tracer is not None
        n = srv.export_trace(str(tmp_path / "again.json"))
    with open(path) as f:
        doc = json.load(f)
    assert len(doc["traceEvents"]) == n > 0
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 and e["pid"] in (1, 2)
               for e in complete)
    assert any(e["pid"] == 2 for e in complete)     # the device clock
    rep = analyze_trace(path)
    assert rep == ref_analyze_trace(path)
    assert rep["requests"] == 8
    assert rep["violations"] == srv.stats.slo_violations > 0
    assert rep["attribution_rate"] == 1.0
    assert "batcher_batches_dispatched" in srv.metrics_text()
