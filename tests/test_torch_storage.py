"""The storage pieces the cluster and the reference's tests call, against
the JAX package's, on the CPU: ``BatchReadPlan``/``BatchReadResult``'s
counters and ``wait_all``, the decoded layout gathers (``gather_docs``,
``gather_docs_into``, ``gather_docs_at``, ``_gather_fixed_at``) on ragged,
fixed-stride and scaled layouts, ``StorageTier.read_async``, and the
drive models of ``storage/ssd`` (the PCIe4 drive's fields and bills).
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import layout_arrays
from repro.storage import layout as ref_layout
from repro.storage import ssd as ref_ssd
from repro.storage.batch_io import BatchReadPlan as RefPlan
from repro.storage.io_engine import StorageTier as RefTier
from repro_torch import convert
from repro_torch.core.rerank import pack_tiles
from repro_torch.storage import layout, ssd
from repro_torch.storage.batch_io import BatchReadPlan
from repro_torch.storage.io_engine import StorageTier

LISTS = [np.array([3, 8, 8, 1]), np.array([8, 3, 40]),
         np.array([], np.int64), np.array([59, 0, 1, 2])]


def layouts(kind, n=60, d_cls=16, d_bow=8, seed=3):
    """A reference layout and the port's copy: ragged fp16, fixed-stride
    (pool_k 12) fp16, or ragged int8 with per-doc scales."""
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((n, d_cls)).astype(np.float32)
    if kind == "fixed":
        bow = [rng.standard_normal((12, d_bow)).astype(np.float32)
               for _ in range(n)]
        ref = ref_layout.pack(cls, bow, dtype=np.float16,
                              mode="fixed_stride", pool_k=12)
    else:
        bow = [rng.standard_normal((int(t), d_bow)).astype(np.float32)
               for t in rng.integers(4, 40, n)]
        if kind == "int8":
            scales = rng.uniform(0.5, 2.0, n).astype(np.float32)
            ref = ref_layout.pack(cls * 20, [b * 20 for b in bow],
                                  dtype=np.int8, scales=scales)
        else:
            ref = ref_layout.pack(cls, bow, dtype=np.float16)
    return ref, convert.layout_from_numpy(layout_arrays(ref))


@pytest.mark.parametrize("kind", ["ragged", "fixed", "int8"])
def test_layout_gathers_match_reference(kind):
    """Every decoded gather equals the reference's bit for bit: padded
    fp32 CLS and BOW and the clipped token counts, into fresh buffers,
    into caller rows 0..n and into scattered rows."""
    ref, port = layouts(kind)
    ids = np.array([5, 0, 59, 5, 17])
    for t_max in (48, 8):
        for got, want in zip(layout.gather_docs(port, ids, t_max),
                             ref_layout.gather_docs(ref, ids, t_max)):
            np.testing.assert_array_equal(got, want)
    rows = np.array([7, 2, 0, 4, 9])
    bufs = [(np.zeros((10, 16), np.float32), np.zeros((10, 48, 8),
                                                       np.float32),
             np.zeros(10, np.int32)) for _ in range(4)]
    layout.gather_docs_at(port, ids, rows, *bufs[0])
    ref_layout.gather_docs_at(ref, ids, rows, *bufs[1])
    layout.gather_docs_into(port, ids, *bufs[2])
    ref_layout.gather_docs_into(ref, ids, *bufs[3])
    for a, b in ((bufs[0], bufs[1]), (bufs[2], bufs[3])):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for i in ids:
        for x, y in zip(layout.unpack_doc(port, int(i)),
                        ref_layout.unpack_doc(ref, int(i))):
            np.testing.assert_array_equal(x, y)
    if kind == "fixed":
        out, want = ([np.zeros((10, 16), np.float32),
                      np.zeros((10, 8, 8), np.float32),
                      np.zeros(10, np.int32)] for _ in range(2))
        layout._gather_fixed_at(port, ids, rows, *out)
        ref_layout._gather_fixed_at(ref, ids, rows, *want)
        for x, y in zip(out, want):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["ragged", "fixed"])
def test_batch_read_plan_matches_reference(kind):
    """The plan's arena order, per-query rows, first-owner attribution
    (per query and per arena row) and counters are the reference's;
    without the per-query run tables too."""
    ref, port = layouts(kind)
    for runs in (True, False):
        got = BatchReadPlan.build(port, LISTS, t_max=48, chunk_docs=2,
                                  with_query_runs=runs)
        want = RefPlan.build(ref, LISTS, chunk_docs=2, with_query_runs=runs)
        for name in ("arena_ids", "arena_blocks", "owned_blocks",
                     "owner_rows"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        for name in ("n_unique", "n_requested", "n_blocks", "runs"):
            assert getattr(got, name) == getattr(want, name)
        for a, b in zip(got.query_rows + got.query_runs,
                        want.query_rows + want.query_runs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("coalesce", [True, False])
def test_batch_read_result_counters_and_wait_all(coalesce):
    """``n_queries``, ``unique_docs`` and ``requested_docs`` equal the
    reference's, coalesced and serial; after ``wait_all`` every row of the
    arena is on its device and decodes to the reference's rows."""
    ref, port = layouts("ragged")
    tier = StorageTier(port, t_max=48, io_chunk_docs=2, device="cpu")
    rtier = RefTier(ref, t_max=48, io_chunk_docs=2)
    got = tier.read_batch(LISTS, coalesce=coalesce)
    want = rtier.read_batch(LISTS, coalesce=coalesce)
    for name in ("n_queries", "unique_docs", "requested_docs"):
        assert getattr(got, name) == getattr(want, name)
    assert got.sim_seconds == want.sim_seconds
    got.wait_all()
    want.wait_all()
    if coalesce:
        assert all(got._landed) and len(got._landed) == len(
            got.plan.runs) > 1
        u = got.plan.n_unique
        tiles, lens = pack_tiles(got.arena, np.arange(u))
        _, bow, wlens = want.arena
        np.testing.assert_array_equal(lens.numpy(), wlens)
        for r in range(u):
            np.testing.assert_array_equal(tiles[r, :wlens[r]].float().numpy(),
                                          bow[r, :wlens[r]])
    tier.close(), rtier.close()


def test_read_async_matches_reference():
    """``read_async``'s future holds the blocking read's result: the
    reference's clock, blocks and rows."""
    ref, port = layouts("ragged")
    tier = StorageTier(port, t_max=48, device="cpu")
    rtier = RefTier(ref, t_max=48)
    ids = np.array([4, 4, 31, 0])
    got = tier.read_async(ids).result(timeout=30)
    want = rtier.read_async(ids).result(timeout=30)
    assert (got.sim_seconds, got.n_blocks) == (want.sim_seconds,
                                               want.n_blocks)
    tiles, lens = pack_tiles(got.arena, np.arange(len(ids)))
    np.testing.assert_array_equal(lens.numpy(), want.lens)
    for j in range(len(ids)):
        np.testing.assert_array_equal(tiles[j, :want.lens[j]].float().numpy(),
                                      want.bow[j, :want.lens[j]])
    assert tier.stats == rtier.stats
    tier.close(), rtier.close()


PAGES = (1, 2, 10, 100, 1_000, 10_000)


def test_pm9a3_pcie4_equals_reference():
    """The PCIe4 drive (the reference's ``PM9A3_PCIE4``): the same fields,
    and the same bills at 1 to 10,000 pages: a batched read at queue depths
    1 and 64, on two drives in RAID-0, and through mmap and swap faults."""
    got, want = ssd.PM9A3_PCIE4, ref_ssd.PM9A3_PCIE4
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.name == "pm9a3-pcie4"
    for n in PAGES:
        for qd in (1, 64):
            assert got.read_time(n, qd=qd) == want.read_time(n, qd=qd)
        assert got.raid0(2).read_time(n) == want.raid0(2).read_time(n)
        for hit in (0.0, 0.5):
            assert (ssd.mmap_read_time(got, n, hit)
                    == ref_ssd.mmap_read_time(want, n, hit))
            assert (ssd.swap_read_time(got, n, hit)
                    == ref_ssd.swap_read_time(want, n, hit))
    # the paper's projection: twice the PCIe3 drive's random IOPS
    assert got.rand_iops == 2 * ssd.PM983_PCIE3.rand_iops


def test_ssd_timing_monotone():
    """The port's counterpart of the reference's test of the same name."""
    for spec in (ssd.PM983_PCIE3, ssd.PM9A3_PCIE4, ssd.DRAM):
        ts = [spec.read_time(n) for n in PAGES]
        assert all(b >= a for a, b in zip(ts, ts[1:]))
    assert ssd.DRAM.read_time(1000) < ssd.PM983_PCIE3.read_time(1000) / 3
    assert ssd.PM9A3_PCIE4.read_time(1000) < ssd.PM983_PCIE3.read_time(1000)
