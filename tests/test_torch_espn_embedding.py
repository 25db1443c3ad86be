"""The port's ESPN-for-RecSys embedding server (``repro_torch.storage.
espn_embedding``) against the JAX package's, on the CPU.

Both are host numpy over the same simulated storage clock, so every stat
(hit rate, prefetch and critical I/O seconds, hidden seconds, blocks) and
every gathered row is held exactly: in the reference tests' cases
(``tests/test_espn_embedding.py``) and in the three (budget, candidates,
hit fraction) settings of ``benchmarks/bench_espn_embedding.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.storage import espn_embedding as ref_ee
from repro_torch.storage import espn_embedding as ee

BENCH_SETTINGS = [(3.0, 1000, 0.9), (3.0, 4000, 0.9), (6.0, 16000, 0.85)]


def stores(rows=10_000, d=64, seed=0):
    t = np.random.default_rng(seed).standard_normal((rows, d)).astype(
        np.float16)
    return ee.EmbeddingBlockStore(table=t), ref_ee.EmbeddingBlockStore(table=t)


def assert_same(got, want):
    (rows_g, st_g), (rows_w, st_w) = got, want
    assert rows_g.dtype == rows_w.dtype == np.float32
    np.testing.assert_array_equal(rows_g, rows_w)
    assert dataclasses.asdict(st_g) == dataclasses.asdict(st_w)


def test_blocking_math():
    s, r = stores(d=64)              # 64 x 2 B = 128 B a row: 32 a block
    assert s.rows_per_block == r.rows_per_block == 32
    assert s.nbytes == r.nbytes
    for rows in (np.arange(32), np.array([0, 32, 64]), np.arange(0, 999, 7)):
        assert s.blocks_for(rows) == r.blocks_for(rows)
    assert s.blocks_for(np.array([0, 32, 64])) == 3
    rows = np.array([5, 99, 5, 1234])
    np.testing.assert_array_equal(s.gather(rows), r.gather(rows))


def test_prefetch_and_direct_match_reference():
    """The reference's prefetch case: 1,200 candidates known early, 900 of
    the 1,000 final rows among them, a 50 ms budget."""
    s, r = stores()
    srv, ref = ee.ESPNEmbeddingServer(s), ref_ee.ESPNEmbeddingServer(r)
    rng = np.random.default_rng(1)
    approx = rng.integers(0, 10_000, 1200)
    final = np.concatenate([approx[:900], rng.integers(0, 10_000, 100)])
    got = srv.fetch(approx, final, overlap_budget_s=0.050)
    assert_same(got, ref.fetch(approx, final, overlap_budget_s=0.050))
    direct = srv.fetch_direct(final)
    assert_same(direct, ref.fetch_direct(final))
    assert got[1].hit_rate > 0.8
    assert got[1].critical_io_s < direct[1].critical_io_s


@pytest.mark.parametrize("budget_s", [1e-6, 10.0])
def test_budget_leak_matches_reference(budget_s):
    """A tiny budget leaks the prefetch into the critical path; a huge one
    hides it all."""
    s, r = stores()
    rows = np.arange(5000)
    got = ee.ESPNEmbeddingServer(s).fetch(rows, rows,
                                          overlap_budget_s=budget_s)
    assert_same(got, ref_ee.ESPNEmbeddingServer(r).fetch(
        rows, rows, overlap_budget_s=budget_s))
    assert (got[1].critical_io_s > 0) == (budget_s < 1.0)


@pytest.fixture(scope="module")
def bench():
    """The benchmark's 2,000,000 x 64 fp16 table and each setting's
    (approx, final) candidate lists, drawn from one generator in its
    order."""
    rng = np.random.default_rng(0)
    rows_ = 2_000_000
    table = rng.standard_normal((rows_, 64)).astype(np.float16)
    lists = []
    for _, n_cand, hit_frac in BENCH_SETTINGS:
        approx = rng.integers(0, rows_, int(n_cand / hit_frac))
        final = np.concatenate([
            approx[: int(n_cand * hit_frac)],
            rng.integers(0, rows_, n_cand - int(n_cand * hit_frac))])
        lists.append((approx, final))
    return (ee.EmbeddingBlockStore(table=table),
            ref_ee.EmbeddingBlockStore(table=table), lists)


@pytest.mark.parametrize("i", range(len(BENCH_SETTINGS)))
def test_benchmark_settings_match_reference(i, bench):
    budget_ms, _, hit_frac = BENCH_SETTINGS[i]
    s, r, lists = bench
    approx, final = lists[i]
    srv, ref = ee.ESPNEmbeddingServer(s), ref_ee.ESPNEmbeddingServer(r)
    got = srv.fetch(approx, final, overlap_budget_s=budget_ms / 1e3)
    assert_same(got, ref.fetch(approx, final,
                               overlap_budget_s=budget_ms / 1e3))
    assert_same(srv.fetch_direct(final), ref.fetch_direct(final))
    assert got[1].hit_rate >= hit_frac - 0.01
