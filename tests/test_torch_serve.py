"""The port's serving layer on the CPU: the continuous batcher, EDF dispatch,
admission control and shedding, timeouts and abandoned requests (as
``tests/test_serve.py`` and ``tests/test_serve_slo.py`` hold the
reference's, without a cluster); the workload generator against the
reference's for one seed; and ``RetrievalServer`` over a ported pipeline,
whose answers equal ``Pipeline.search``'s of the same query.

Every wait has a timeout and every server and batcher stops in a
``finally``, so no test can hang the suite.
"""
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_parity import (artifacts, configs, index_arrays, layout_arrays,
                           SCORE_TOL)
from repro.serve import workload as ref_workload
from repro_torch import convert
from repro_torch.pipeline import Pipeline
from repro_torch.serve import workload as W
from repro_torch.serve.engine import RetrievalServer, ShedError
from repro_torch.serve.scheduler import (BatchPolicy, ContinuousBatcher,
                                         Request, ServiceModel)
from repro_torch.serve.slo import (AdmissionController, SLOPolicy,
                                   eq4_max_batch)

WAIT = 10.0        # seconds any single wait may take


class FakeRetriever:
    """Fixed-cost handler: real wall sleep + a fixed simulated device bill."""

    def __init__(self, delay_s=0.01, sim_s=0.001):
        self.delay_s = delay_s
        self.sim_s = sim_s

    def query_batch(self, q_cls, q_bow, q_lens, **kw):
        time.sleep(self.delay_s)
        bd = SimpleNamespace(total_s=self.sim_s, encode_s=0.0, hit_rate=1.0)
        return SimpleNamespace(ranked=[[(i, 1.0)] for i in range(len(q_cls))],
                               breakdown=bd)


def fake_query(d_cls=8, d_bow=8, t=4):
    return np.zeros(d_cls, np.float32), np.zeros((t, d_bow), np.float32), t


def echo(seen):
    def handler(batch):
        seen.append([r.rid for r in batch])
        for r in batch:
            r.result = r.payload
    return handler


def run_batcher(batcher, reqs, started=False):
    try:
        if not started:
            batcher.start()
        for r in reqs:
            assert r.done.wait(WAIT)
    finally:
        batcher.stop()


# -- the batcher ------------------------------------------------------------------

def test_continuous_batcher_batches_requests():
    seen = []
    b = ContinuousBatcher(echo(seen), BatchPolicy(max_batch=4,
                                                  max_wait_s=0.05))
    reqs = [Request(i, i) for i in range(8)]
    b.start()
    for r in reqs:
        b.submit(r)
    run_batcher(b, reqs, started=True)
    assert sorted(sum(seen, [])) == list(range(8))
    assert max(map(len, seen)) >= 2              # actually batched
    assert all(r.result == r.payload for r in reqs)


def test_backlog_dispatches_full_batches_not_singletons():
    seen = []
    b = ContinuousBatcher(echo(seen), BatchPolicy(max_batch=4,
                                                  max_wait_s=0.002))
    reqs = [Request(i, i) for i in range(8)]
    for r in reqs:
        b.submit(r)
    time.sleep(0.05)                 # age the whole backlog past max_wait
    run_batcher(b, reqs)
    assert [len(x) for x in seen] == [4, 4]


def test_on_complete_runs_before_done_and_window_clamps():
    seen = []
    b = ContinuousBatcher(echo([]), BatchPolicy(max_batch=2, max_wait_s=0.01),
                          on_complete=lambda r: seen.append(r.rid))
    reqs = [Request(i, i) for i in range(4)]
    for r in reqs:
        b.submit(r)
    run_batcher(b, reqs)
    assert sorted(seen) == [0, 1, 2, 3]
    assert all(r.latency_s > 0 for r in reqs)
    assert b._window_end(100.0, 105.0) == pytest.approx(100.01)
    assert b._window_end(105.0, 100.0) == pytest.approx(100.01)


def test_edf_orders_dispatch_by_deadline_and_static_keeps_fifo():
    for aware, want in ((True, [3, 1, 2, 0]), (False, [0, 1, 2, 3])):
        seen = []
        pol = BatchPolicy(max_batch=2, max_wait_s=0.01, deadline_aware=aware)
        b = ContinuousBatcher(echo(seen), pol)   # not started: queue builds
        now = time.monotonic()
        reqs = []
        for rid, budget in {0: 0.9, 1: 0.2, 2: 0.5, 3: 0.05}.items():
            r = Request(rid, rid)
            r.deadline_s = now + budget
            reqs.append(r)
            b.submit(r)
        run_batcher(b, reqs)
        assert [rid for batch in seen for rid in batch] == want


def test_abandoned_request_dropped_before_dispatch():
    seen = []
    b = ContinuousBatcher(echo(seen), BatchPolicy(max_batch=4,
                                                  max_wait_s=0.005))
    live, gone = Request(0, 0), Request(1, 1)
    gone.abandoned = True
    b.submit(live)
    b.submit(gone)
    run_batcher(b, [live, gone])     # gone completes without a slot
    assert seen == [[0]]


def test_handler_exception_fails_batch_but_loop_survives():
    calls = {"n": 0}

    def handler(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("backend blew up")
        for r in batch:
            r.result = "ok"

    b = ContinuousBatcher(handler, BatchPolicy(max_batch=4, max_wait_s=0.01))
    first = [Request(i, None) for i in range(4)]
    second = Request(99, None)
    try:
        b.start()
        for r in first:
            b.submit(r)
        for r in first:
            assert r.done.wait(WAIT)
            assert r.error is not None and r.result is None
        assert b.errors == 4 and b._thread.is_alive()
        b.submit(second)
        assert second.done.wait(WAIT)
    finally:
        b.stop()
    assert second.error is None and second.result == "ok"


# -- admission and the server ------------------------------------------------------

def test_admission_always_admits_cold_or_deadline_free():
    svc = ServiceModel()
    adm = AdmissionController(svc, SLOPolicy(max_batch=4))
    r = Request(0, None)
    r.deadline_s = r.arrival_s + 0.001
    assert adm.admit(r, depth=10_000, now=time.monotonic())  # cold model
    svc.observe(4, 0.5)
    free = Request(1, None)                                  # no deadline
    assert adm.admit(free, depth=10_000, now=time.monotonic())
    assert not adm.admit(r, depth=10_000, now=time.monotonic())
    assert adm.shed_count == 1


def test_server_sheds_under_overload_and_protects_loose_tenant():
    srv = RetrievalServer(FakeRetriever(delay_s=0.02),
                          policy=SLOPolicy(max_batch=4, max_wait_s=0.002,
                                           slo_ms=40.0))
    try:
        srv.batcher.service.observe(1, 0.02)
        srv.batcher.service.observe(4, 0.022)
        q, bow, t = fake_query()
        reqs = [srv.query_async(q, bow, t, tenant="tight")
                for _ in range(40)]
        loose = [srv.query_async(q, bow, t, tenant="loose", slo_ms=10_000.0)
                 for _ in range(8)]
        for r in reqs + loose:
            assert r.done.wait(WAIT)
    finally:
        srv.shutdown()
    s = srv.stats
    assert s.shed > 0 and s.shed == sum(r.shed for r in reqs)
    assert all(r.result is None for r in reqs if r.shed)
    assert s.served_in_slo + s.slo_violations + s.shed == s.offered == 48
    tl = s.tenant("loose")
    assert (tl.offered, tl.shed, tl.violations, tl.in_slo) == (8, 0, 0, 8)


def test_blocking_query_raises_shed_error():
    srv = RetrievalServer(FakeRetriever(delay_s=0.05),
                          policy=SLOPolicy(max_batch=1, max_wait_s=0.001,
                                           slo_ms=1.0))
    try:
        srv.batcher.service.observe(1, 0.05)   # forecast: certain miss
        q, bow, t = fake_query()
        srv.query_async(q, bow, t)             # occupy the queue
        with pytest.raises(ShedError):
            srv.query(q, bow, t, timeout=WAIT)
    finally:
        srv.shutdown()


def test_query_timeout_not_billed_as_served():
    srv = RetrievalServer(FakeRetriever(delay_s=0.2),
                          policy=BatchPolicy(max_batch=2, max_wait_s=0.001))
    try:
        q, bow, t = fake_query()
        with pytest.raises(TimeoutError):
            srv.query(q, bow, t, timeout=0.01)
        deadline = time.monotonic() + WAIT
        while srv.stats.n_requests == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.stats.timeouts == 1
        assert len(srv.stats.latencies_ms) == 0     # abandoned: not billed
        assert srv.query(q, bow, t, timeout=WAIT) is not None
        assert len(srv.stats.latencies_ms) == 1
    finally:
        srv.shutdown()


def test_eq4_max_batch_clamps():
    pf = SimpleNamespace(batch_threshold=lambda nprobe, bpq: 23.7)
    assert eq4_max_batch(pf, 8, 1e6) == 24
    pf = SimpleNamespace(batch_threshold=lambda nprobe, bpq: 0.0)
    assert eq4_max_batch(pf, 8, 1e6, lo=2) == 2


# -- the workload generator ----------------------------------------------------------

@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_workload_equals_the_reference(process):
    c, _, _ = artifacts()
    kw = dict(duration_s=1.0, process=process, rate_qps=150,
              diurnal_period_s=1.0, seed=3)
    ours = W.generate(W.WorkloadConfig(**kw), c)
    ref = ref_workload.generate(ref_workload.WorkloadConfig(**kw), c)
    assert ours.n == ref.n > 50
    assert [(a.t_s, a.tenant, a.slo_ms, a.query) for a in ours.arrivals] == \
        [(a.t_s, a.tenant, a.slo_ms, a.query) for a in ref.arrivals]
    for f in ("q_cls", "q_bow", "q_lens", "target_docs"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    mix = dict(duration_s=1.0, seed=2)
    tenants = [("online", 200.0, 30.0), ("batch", 50.0, 500.0)]
    ours = W.generate(W.WorkloadConfig(
        **mix, tenants=[W.TenantSpec(*t) for t in tenants]), c)
    ref = ref_workload.generate(ref_workload.WorkloadConfig(
        **mix, tenants=[ref_workload.TenantSpec(*t) for t in tenants]), c)
    assert [(a.t_s, a.tenant) for a in ours.arrivals] == \
        [(a.t_s, a.tenant) for a in ref.arrivals]
    with pytest.raises(ValueError, match="unknown arrival process"):
        W.arrival_times(W.WorkloadConfig(process="sawtooth"), 100.0,
                        np.random.default_rng(0))


# -- the server over a ported pipeline ---------------------------------------------

def port_pipeline(mode="espn", **serve):
    c, index, layout = artifacts()
    _, cfg = configs(mode)
    for k, v in serve.items():
        setattr(cfg.serve, k, v)
    return Pipeline.from_artifacts(
        cfg, index=convert.ivf_index_from_numpy(index_arrays(index), "cpu"),
        layout=convert.layout_from_numpy(layout_arrays(layout)),
        corpus=c, device="cpu")


@pytest.mark.parametrize("mode", ["espn", "bitvec"])
def test_server_answers_equal_search(mode):
    """Each request's ids equal ``search`` of that query alone, its
    scores within 1e-5 (the batch a request lands in changes its bill,
    not its ranking)."""
    c, _, _ = artifacts()
    with port_pipeline(mode, max_batch=4, max_wait_s=0.01) as pipe:
        want = [pipe.search(c.queries_cls[i:i + 1], c.queries_bow[i:i + 1],
                            c.query_lens[i:i + 1]).ranked[0]
                for i in range(len(c.query_lens))]
        srv = pipe.serve()
        try:
            reqs = [srv.query_async(c.queries_cls[i], c.queries_bow[i],
                                    int(c.query_lens[i]))
                    for i in range(len(c.query_lens))]
            for r in reqs:
                assert r.done.wait(WAIT)
            blocking = srv.query(c.queries_cls[0], c.queries_bow[0],
                                 int(c.query_lens[0]), timeout=WAIT)
        finally:
            srv.shutdown()
    for r, w in zip(reqs, want):
        assert r.error is None and not r.shed
        np.testing.assert_array_equal(r.result.doc_ids, w.doc_ids)
        np.testing.assert_allclose(r.result.scores, w.scores, rtol=0,
                                   atol=SCORE_TOL)
    np.testing.assert_array_equal(blocking.doc_ids, want[0].doc_ids)
    s = srv.stats.summary()
    assert s["n"] == len(reqs) + 1 and s["p99_ms"] > 0
    assert s["mean_batch"] > 1


def test_espn_retriever_dispatches_to_the_backend():
    """``ESPNRetriever`` resolves its mode in the registry and answers as
    the pipeline's backend does; the server runs over it too."""
    from repro_torch.core.espn import ESPNRetriever
    c, _, _ = artifacts()
    q = (c.queries_cls[:4], c.queries_bow[:4], c.query_lens[:4])
    with port_pipeline("gds") as pipe:
        want = pipe.search(*q)
        ret = ESPNRetriever(pipe.index, pipe.tier,
                            pipe.cfg.retrieval.to_espn_config())
        assert ret.backend.name == "gds" and ret.tier is pipe.tier
        got = ret.query_batch(*q)
        for w, g in zip(want.ranked, got.ranked):
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
            np.testing.assert_array_equal(g.scores, w.scores)
        assert got.breakdown.as_dict()["total_ms"] == \
            want.breakdown.as_dict()["total_ms"]
        srv = RetrievalServer(ret, policy=BatchPolicy(max_batch=2))
        try:
            out = srv.query(q[0][0], q[1][0], int(q[2][0]), timeout=WAIT)
        finally:
            srv.shutdown()
        np.testing.assert_array_equal(out.doc_ids, want.ranked[0].doc_ids)
        with pytest.raises(KeyError, match="unknown retrieval backend"):
            ESPNRetriever(pipe.index, pipe.tier, dataclasses.replace(
                pipe.cfg.retrieval.to_espn_config(), mode="colbert"))


def test_serve_builds_the_slo_policy_and_refuses_autoscale():
    with port_pipeline(slo_ms=50.0, max_batch=8) as pipe:
        srv = pipe.serve()
        try:
            assert isinstance(srv.policy, SLOPolicy)
            assert srv.policy.slo_ms == 50.0 and srv.policy.max_batch == 8
            assert srv.batcher.admission is not None
        finally:
            srv.shutdown()
        pipe.cfg.serve.autoscale = True
        # the autoscaler drives a cluster's replicas: a single tier has none
        with pytest.raises(RuntimeError, match="requires the cluster tier"):
            pipe.serve()
    with port_pipeline() as pipe:
        srv = pipe.serve()
        try:
            assert type(srv.policy) is BatchPolicy
            assert srv.batcher.admission is None
        finally:
            srv.shutdown()


def test_backend_error_reaches_the_caller(monkeypatch):
    """A kernel error raised on the batcher's thread fails its requests:
    the blocking caller gets the exception, the ledger counts an error,
    and the server keeps serving."""
    c, _, _ = artifacts()
    with port_pipeline(max_batch=2, max_wait_s=0.001) as pipe:
        real = pipe.backend.query_batch
        calls = {"n": 0}

        def failing(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("maxsim kernel launch failed: CUDA "
                                   "error 700")
            return real(*a, **kw)
        monkeypatch.setattr(pipe.backend, "query_batch", failing)
        srv = pipe.serve()
        try:
            q = (c.queries_cls[0], c.queries_bow[0], int(c.query_lens[0]))
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                srv.query(*q, timeout=WAIT)
            assert srv.query(*q, timeout=WAIT).doc_ids.size > 0
        finally:
            srv.shutdown()
    assert srv.stats.errors == 1 and srv.stats.n_requests == 1
