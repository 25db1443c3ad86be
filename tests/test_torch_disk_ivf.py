"""The port's SPANN-style disk IVF (``repro_torch.core.disk_ivf``) against
the JAX package's, on the CPU.

Every case of ``tests/test_disk_ivf.py`` runs on the port. Beside them, the
same in-memory index (the reference builds it; ``repro_torch.convert``
carries it across) is packed by both packages: the disk image, the offsets
and the sizes must be equal byte for byte in fp32, fp16 and int8 index
quants, and ``memory_bytes`` exactly. ``search_disk`` must give the
reference's ids, scores within ``SCORE_TOL`` (fp32 sums taken in another
order), and exactly its I/O bill and ``stats``, with a cold and a warm
hot-cell cache (one that holds every cell, and one small enough to evict).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import SCORE_TOL, index_arrays
from repro.core import disk_ivf as ref_disk
from repro.core.ivf import build_ivf as ref_build_ivf
from repro.storage import ssd as ref_ssd
from repro_torch import convert
from repro_torch.core.disk_ivf import build_disk_ivf, search_disk
from repro_torch.core.ivf import search
from repro_torch.storage import ssd as S

QUANTS = ("fp32", "fp16", "int8")


@functools.lru_cache(maxsize=None)
def ref_index(quant):
    from repro.data.synthetic import make_corpus
    c = make_corpus(n_docs=2000, n_queries=24, n_clusters=32, mean_len=30,
                    max_len=64, seed=0)
    return c, ref_build_ivf(c.cls, ncells=16, iters=4, quant=quant)


def indices(quant="fp32"):
    """The corpus, the reference's in-memory index and the port's copy."""
    c, mem = ref_index(quant)
    return c, mem, convert.ivf_index_from_numpy(index_arrays(mem), "cpu")


# -- the reference's cases, on the port ---------------------------------------

def test_disk_search_matches_memory_search():
    c, _, mem = indices()
    disk = build_disk_ivf(mem, cache_cells=0)
    q = c.queries_cls[:8]
    _, i_mem = search(mem, q, nprobe=8, k=20)
    _, i_dsk, io_s = search_disk(disk, q, nprobe=8, k=20)
    assert io_s > 0
    for b in range(8):
        got = set(i_dsk[b].tolist()) - {-1}
        want = set(i_mem[b].tolist()) - {-1}
        # fp16 posting storage can flip near-tied ranks at the boundary
        assert len(got & want) >= 18


def test_memory_factor():
    _, _, mem = indices()
    disk = build_disk_ivf(mem, cache_cells=0)
    assert disk.memory_bytes() < mem.memory_bytes() / 20


def test_hot_cell_cache():
    c, _, mem = indices()
    disk = build_disk_ivf(mem, cache_cells=mem.ncells)   # all cells fit
    q = c.queries_cls[:4]
    _, _, io_cold = search_disk(disk, q, nprobe=8, k=10)
    _, _, io_warm = search_disk(disk, q, nprobe=8, k=10)  # same queries
    assert io_cold > 0
    assert io_warm == 0.0                                 # fully cached
    assert disk.stats["cache_hits"] > 0


def test_raid0_scaling():
    base = S.PM983_PCIE3
    r4 = base.raid0(4)
    n = 100_000
    assert r4.read_time(n) < base.read_time(n) / 2.5
    assert r4.rand_iops == base.rand_iops * 4
    # the reference's spec, field for field, and its clock
    want = ref_ssd.PM983_PCIE3.raid0(4)
    assert (r4.name, r4.base_latency_s, r4.device_latency_s, r4.rand_iops,
            r4.seq_bw, r4.block) == (
        want.name, want.base_latency_s, want.device_latency_s,
        want.rand_iops, want.seq_bw, want.block)
    for blocks, qd in ((1, 1), (37, 8), (n, 64)):
        assert r4.read_time(blocks, qd) == want.read_time(blocks, qd)


# -- the disk image against the reference's -----------------------------------

@pytest.mark.parametrize("quant", QUANTS)
def test_disk_image_equals_reference(quant):
    _, ref_mem, mem = indices(quant)
    want = ref_disk.build_disk_ivf(ref_mem)
    got = build_disk_ivf(mem)
    assert got.blob.dtype == want.blob.dtype == np.uint8
    assert got.blob.tobytes() == want.blob.tobytes()
    np.testing.assert_array_equal(got.cell_offsets, want.cell_offsets)
    assert got.cell_offsets.dtype == want.cell_offsets.dtype
    np.testing.assert_array_equal(got.cell_sizes, want.cell_sizes)
    assert (got.d, got.n_docs, got.block) == (want.d, want.n_docs,
                                              want.block)
    np.testing.assert_array_equal(got.centroids.numpy(),
                                  np.asarray(want.centroids))
    for cells in (0, 3, mem.ncells):
        assert build_disk_ivf(mem, cache_cells=cells).memory_bytes() == \
            ref_disk.build_disk_ivf(ref_mem, cache_cells=cells).memory_bytes()


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("cache_cells", [0, 3, 16])
def test_search_disk_equals_reference(quant, cache_cells):
    """Two passes over the same queries (cold, then warm: with 16 cells
    every cell is cached, with 3 the LRU evicts): ids equal, scores within
    ``SCORE_TOL``, the bill and the stats exactly equal after each."""
    c, ref_mem, mem = indices(quant)
    want = ref_disk.build_disk_ivf(ref_mem, cache_cells=cache_cells)
    got = build_disk_ivf(mem, cache_cells=cache_cells)
    q = c.queries_cls[:12]
    for _ in range(2):
        ws, wi, wio = ref_disk.search_disk(want, q, nprobe=6, k=40)
        gs, gi, gio = search_disk(got, q, nprobe=6, k=40)
        assert gi.dtype == np.asarray(wi).dtype == np.int32
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=0,
                                   atol=SCORE_TOL)
        assert gio == wio
        assert got.stats == want.stats
        assert list(got._cache) == list(want._cache)
        assert got.memory_bytes() == want.memory_bytes()
    if cache_cells == 16:
        assert gio == 0.0 and got.stats["cache_hits"] > 0


def test_search_disk_fills_short_lists_like_the_reference():
    """k above the probed postings: the tail is NEG / -1 in both; a query
    whose probed cells are all empty answers all NEG / -1."""
    c, ref_mem, mem = indices()
    want, got = ref_disk.build_disk_ivf(ref_mem), build_disk_ivf(mem)
    q = c.queries_cls[:3]
    ws, wi, wio = ref_disk.search_disk(want, q, nprobe=1, k=2000)
    gs, gi, gio = search_disk(got, q, nprobe=1, k=2000)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=0, atol=SCORE_TOL)
    assert (gi == -1).any() and gio == wio
    for d in (want, got):
        d.cell_sizes = np.zeros_like(d.cell_sizes)
    ws, wi, _ = ref_disk.search_disk(want, q, nprobe=2, k=5)
    gs, gi, _ = search_disk(got, q, nprobe=2, k=5)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gs, np.asarray(ws))
    assert (gi == -1).all()


def test_memory_search_overlap_matches_reference():
    """The reference test's overlap gate holds for both packages on the
    same index, and the port's disk answers equal the reference's."""
    c, ref_mem, mem = indices()
    q = c.queries_cls[:8]
    from repro.core.ivf import search as ref_search
    _, ri = ref_search(ref_mem, jnp.asarray(q), nprobe=8, k=20)
    _, pi = search(mem, q, nprobe=8, k=20)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    _, di, _ = search_disk(build_disk_ivf(mem), q, nprobe=8, k=20)
    for b in range(8):
        assert len(set(di[b].tolist()) & set(pi[b].tolist())) >= 18
