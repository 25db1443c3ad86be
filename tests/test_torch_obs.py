"""The port's observability layer against the JAX reference, on the CPU:
streaming histograms and the metrics exposition give the reference's
numbers and text; a traced batch gives the reference's span tree (names,
categories, parents, query ids and simulated seconds; wall times differ by
nature) in every single-tier mode, faulted or not; tracing changes no id,
score or bill; and the Perfetto export loads in both packages' analyzers.
"""
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
from repro_torch.obs import MetricsRegistry, StreamingHistogram, analyze_trace
from repro_torch.obs.analyze import dominant_stage
from repro_torch.pipeline import Pipeline
from repro_torch.serve.engine import ServeStats
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


@pytest.mark.parametrize("fault_kw", [None, FAULTS], ids=["plain", "faulted"])
@pytest.mark.parametrize("mode", MODES)
def test_span_tree_equals_the_reference(mode, fault_kw):
    r, p, r_spans, p_spans = traced_both(mode, fault_kw)
    assert tree(p_spans) == tree(r_spans)
    assert p.breakdown.as_dict() == r.breakdown.as_dict()
    # the per-query spans reconcile with the batch breakdown
    bd = p.breakdown
    assert sum(s.sim_s for s in p_spans if s.name == "critical_io") == \
        pytest.approx(bd.critical_io_s, abs=1e-12)
    assert sum(s.sim_s for s in p_spans if s.name in ("rerank",
                                                     "bit_filter")) == \
        pytest.approx(bd.rerank_s, abs=1e-12)
    for s in p_spans:                     # wall intervals nest
        if s.parent is not None:
            par = next(x for x in p_spans if x.sid == s.parent)
            assert par.t0 <= s.t0 and s.t1 <= par.t1
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
