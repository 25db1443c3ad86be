"""Storage fault injection in the port, against the JAX reference, on the
CPU.

The fault schedule is a pure function of the seed and the read sequence,
and the port draws it in the reference's order, so a faulted run must give
the reference's answers: the same degraded queries (answered from their
candidate scores, no MaxSim), the same fault counters, the same simulated
bill, and, for the queries that were scored, the reference's ids (adjacent
near-tie swaps allowed) and scores within 1e-5. An undetected corruption
flips the sign of the victim's rows in both packages; a detected one is
repaired and billed.
"""
import argparse
import dataclasses

import numpy as np
import pytest

from _torch_parity import (artifacts, assert_same_ranking, configs,
                           index_arrays, layout_arrays, port_tables)
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.storage import faults as ref_faults
from repro.storage.layout import pack as ref_pack
from repro_torch import convert
from repro_torch.pipeline import Pipeline, PipelineConfig, available_backends
from repro_torch.storage import faults

BATCH = 4          # the parity corpus's 12 queries in three batches


def run_both(mode, fault_kw, io_coalesce=True, **retrieval):
    """Both packages' responses, batch by batch, with the same faults, and
    the tiers' counters after the last batch."""
    c, index, layout = artifacts()
    ref_cfg, port_cfg = configs(mode, **retrieval)
    ref_cfg.faults = ref_faults.FaultConfig(**fault_kw)
    port_cfg.faults = faults.FaultConfig(**fault_kw)
    ref_cfg.storage.io_coalesce = port_cfg.storage.io_coalesce = io_coalesce
    batches = [(c.queries_cls[i:i + BATCH], c.queries_bow[i:i + BATCH],
                c.query_lens[i:i + BATCH])
               for i in range(0, len(c.query_lens), BATCH)]
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        r = [ref.search(*q) for q in batches]
        r_stats = dict(ref.tier.stats)
        tables = port_tables(ref)
    with Pipeline.from_artifacts(
            port_cfg, index=convert.ivf_index_from_numpy(
                index_arrays(index), "cpu"),
            layout=convert.layout_from_numpy(layout_arrays(layout)),
            device="cpu", **tables) as port:
        p = [port.search(*q) for q in batches]
        p_stats = dict(port.tier.stats)
    return r, p, r_stats, p_stats


def assert_same_faulted(r, p, r_stats, p_stats):
    for rb, pb in zip(r, p):
        assert pb.breakdown.as_dict() == rb.breakdown.as_dict()
        for ro, po in zip(rb.ranked, pb.ranked):
            assert po.degraded == ro.degraded
            assert (po.n_reranked, po.bow_bytes_read) == (
                ro.n_reranked, ro.bow_bytes_read)
            assert_same_ranking(ro, po)
    assert p_stats == r_stats


ERRORS = dict(read_error_rate=0.5, read_retries=0, seed=3)
RETRIES = dict(read_error_rate=0.4, stall_rate=0.5, read_retries=2, seed=1)
CORRUPT = dict(corruption_rate=0.7, seed=2)
REPAIRED = dict(corruption_rate=0.7, checksum=True, seed=2)
FLAPS = dict(flap_rate=0.4, stall_rate=0.3, seed=5)

CASES = [
    ("espn", ERRORS, True), ("gds", ERRORS, True), ("bitvec", ERRORS, True),
    ("cascade", ERRORS, True), ("gds", ERRORS, False),
    ("espn", RETRIES, True), ("mmap", RETRIES, True),
    ("espn", CORRUPT, True), ("gds", CORRUPT, True),
    ("bitvec", CORRUPT, False), ("fde", REPAIRED, True),
    ("espn", REPAIRED, False), ("dram", FLAPS, True),
]


@pytest.mark.parametrize("mode,fault_kw,coalesce", CASES,
                         ids=[f"{m}-{i}-{'coalesced' if c else 'serial'}"
                              for i, (m, _, c) in enumerate(CASES)])
def test_faulted_run_matches_reference(mode, fault_kw, coalesce):
    r, p, r_stats, p_stats = run_both(mode, fault_kw, io_coalesce=coalesce)
    assert_same_faulted(r, p, r_stats, p_stats)
    # the case exercises what it names
    assert r_stats["faults_injected"] > 0
    if fault_kw is ERRORS:
        assert sum(b.breakdown.degraded_queries for b in r) > 0
    if fault_kw is CORRUPT:
        assert r_stats["corruptions_injected"] > 0
    if fault_kw is REPAIRED:
        assert r_stats["repairs"] > 0 and r_stats["checksum_failures"] > 0


def test_corruption_of_a_scaled_int8_layout_matches_reference():
    """An int8 layout with per-doc scales (the reference's quantized
    storage, carried across): an undetected corruption negates the
    victim's scale instead of its int8 rows (-(-128) does not fit in
    int8), which flips the sign of every dequantized value, as the
    reference's flip of the dequantized rows does."""
    c, index, _ = artifacts()
    scales = np.array([max(float(np.abs(b).max()), float(np.abs(x).max()))
                       / 127.0 for b, x in zip(c.bow, c.cls)], np.float32)
    layout = ref_pack(c.cls, c.bow, dtype=np.int8, scales=scales)
    kw = dict(corruption_rate=0.9, seed=2)
    ref_cfg, port_cfg = configs("gds")
    ref_cfg.faults = ref_faults.FaultConfig(**kw)
    port_cfg.faults = faults.FaultConfig(**kw)
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    for coalesce in (True, False):
        ref_cfg.storage.io_coalesce = port_cfg.storage.io_coalesce = coalesce
        with RefPipeline.from_artifacts(ref_cfg, index=index,
                                        layout=layout) as ref:
            r = [ref.search(*q)]
            r_stats = dict(ref.tier.stats)
        with Pipeline.from_artifacts(
                port_cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(layout)),
                device="cpu") as port:
            p = [port.search(*q)]
            p_stats = dict(port.tier.stats)
        assert r_stats["corruptions_injected"] > 0
        assert_same_faulted(r, p, r_stats, p_stats)


def test_degraded_query_launches_no_maxsim(monkeypatch):
    """Every read fails: every query is degraded, ranks by its candidate
    scores, and no MaxSim runs (the kernel's plain version is never
    called)."""
    from repro_torch.core import rerank
    calls = []
    monkeypatch.setattr(rerank, "_maxsim_np",
                        lambda *a, **k: calls.append(1))
    kw = dict(read_error_rate=1.0, read_retries=0)
    for mode in ("espn", "gds", "bitvec"):
        r, p, r_stats, p_stats = run_both(mode, kw)
        assert_same_faulted(r, p, r_stats, p_stats)
        assert all(o.degraded and o.n_reranked == 0
                   for b in p for o in b.ranked)
        assert all(b.breakdown.degraded_queries == BATCH for b in p)
    assert calls == []


@pytest.mark.parametrize("mode", ["espn", "gds"])
def test_no_degrade_raises_typed_error(mode):
    c, index, layout = artifacts()
    kw = dict(read_error_rate=1.0, read_retries=0, degrade=False)
    ref_cfg, port_cfg = configs(mode)
    ref_cfg.faults = ref_faults.FaultConfig(**kw)
    port_cfg.faults = faults.FaultConfig(**kw)
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        with pytest.raises(ref_faults.DegradedQueryError):
            ref.search(*q)
    with Pipeline.from_artifacts(
            port_cfg, index=convert.ivf_index_from_numpy(
                index_arrays(index), "cpu"),
            layout=convert.layout_from_numpy(layout_arrays(layout)),
            device="cpu") as port:
        with pytest.raises(faults.DegradedQueryError):
            port.search(*q)


# -- the schedule ---------------------------------------------------------------

def test_fault_schedule_draws_equal_the_reference():
    kw = dict(read_error_rate=0.3, stall_rate=0.2, corruption_rate=0.1,
              flap_rate=0.1, read_retries=3, checksum=True, seed=7)
    ours = faults.FaultInjector(faults.FaultConfig(**kw))
    ref = ref_faults.FaultInjector(ref_faults.FaultConfig(**kw))
    for seq in range(300):
        for shard, rep in ((0, 0), (1, 2)):
            assert ours.any_event(seq, shard, rep) == ref.any_event(
                seq, shard, rep)
            assert ours.flap(seq, shard, rep) == ref.flap(seq, shard, rep)
            assert ours.corrupt(seq, shard) == ref.corrupt(seq, shard)
            assert ours.victim(seq, shard, 37) == ref.victim(seq, shard, 37)
            for att in range(3):
                assert ours.read_error(seq, shard, rep, att) == \
                    ref.read_error(seq, shard, rep, att)
                assert ours.stall(seq, shard, rep, att) == \
                    ref.stall(seq, shard, rep, att)
            ev_a, ev_b = faults.zero_fault_stats(), \
                ref_faults.zero_fault_stats()
            assert ours.attempt_loop(seq, shard, rep, 1e-3, ev_a) == \
                ref.attempt_loop(seq, shard, rep, 1e-3, ev_b)
            assert ev_a == ev_b
            assert faults.fault_span_counts(ev_a) == \
                ref_faults.fault_span_counts(ev_b)
    assert ours.backoff_s(3) == ref.backoff_s(3)
    _, _, layout = artifacts()
    port_layout = convert.layout_from_numpy(layout_arrays(layout))
    faults.add_checksums(port_layout)
    ref_faults.add_checksums(layout)
    try:
        for gid in range(0, layout.n_docs, 97):
            assert ours.wire_corruption_detected(port_layout, gid)
            assert ref.wire_corruption_detected(layout, gid)
    finally:
        layout.checksums = None                # the shared artifact
    assert not ours.wire_corruption_detected(
        convert.layout_from_numpy(layout_arrays(layout)), 0)


@pytest.mark.parametrize("mode", available_backends())
def test_zero_fault_config_is_bitwise_invisible(mode):
    """An injector with every rate zero (and checksums on) changes no id,
    score or bill in any single-tier mode."""
    c, index, layout = artifacts()
    _, plain_cfg = configs(mode)
    quiet_cfg = dataclasses.replace(
        plain_cfg, faults=faults.FaultConfig(checksum=True))
    out = []
    for cfg in (plain_cfg, quiet_cfg):
        with Pipeline.from_artifacts(
                cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(layout)),
                device="cpu") as pipe:
            assert (pipe.tier.faults is None) == (cfg is plain_cfg)
            out.append(pipe.search(c.queries_cls, c.queries_bow,
                                   c.query_lens))
    a, b = out
    for x, y in zip(a.ranked, b.ranked):
        np.testing.assert_array_equal(x.doc_ids, y.doc_ids)
        np.testing.assert_array_equal(x.scores, y.scores)
        assert not y.degraded
    assert a.breakdown.as_dict() == b.breakdown.as_dict()
    assert b.breakdown.faults_injected == 0


# -- config ---------------------------------------------------------------------

ARGV = ["--fault-rate", "0.02", "--fault-stall-rate", "0.01",
        "--fault-corruption-rate", "0.005", "--fault-flap-rate", "0.001",
        "--fault-seed", "9", "--read-retries", "3", "--retry-backoff-ms",
        "2.0", "--checksum", "--no-degrade", "--slo-ms", "35",
        "--static-serve", "--trace-json", "t.json", "--metrics-out", "m.txt",
        "--shards", "2", "--mutation", "--mode", "bitvec"]


def test_fault_config_dict_and_cli_round_trip_across_packages():
    ours = PipelineConfig.from_cli(
        PipelineConfig.add_cli_args(argparse.ArgumentParser()).parse_args(
            ARGV))
    ref = RefConfig.from_cli(
        RefConfig.add_cli_args(argparse.ArgumentParser()).parse_args(ARGV))
    f = ours.faults
    assert (f.read_error_rate, f.stall_rate, f.corruption_rate,
            f.flap_rate) == (0.02, 0.01, 0.005, 0.001)
    assert f.read_retries == 3 and f.retry_backoff_ms == 2.0
    assert f.checksum and not f.degrade and f.seed == 9
    assert ours.obs.trace and ours.obs.trace_path == "t.json"
    assert ours.to_dict() == ref.to_dict()
    assert PipelineConfig.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert RefConfig.from_dict(ours.to_dict()).to_dict() == ours.to_dict()
    assert PipelineConfig.from_dict(ours.to_dict()) == ours
    # the defaults parse to the inert config in both packages
    ours0 = PipelineConfig.from_cli(
        PipelineConfig.add_cli_args(argparse.ArgumentParser()).parse_args([]))
    ref0 = RefConfig.from_cli(
        RefConfig.add_cli_args(argparse.ArgumentParser()).parse_args([]))
    assert not ours0.faults.active()
    assert ours0.to_dict() == ref0.to_dict()
    with pytest.raises(KeyError, match="unknown PipelineConfig sections"):
        PipelineConfig.from_dict({"shards": {}})
