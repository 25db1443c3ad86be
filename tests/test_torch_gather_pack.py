"""The port's restructuring step (``kernels/gather_pack`` and the device
arena the storage tier hands the rerank) on the CPU, against the JAX
package.

A copy has no rounding, so every comparison here is exact: the plain
version against the reference's oracle ``gather_pack_ref`` (its Pallas
kernel does not run on this jax, see ROADMAP Queue C), and the arena's
packed, widened and scaled tiles against the reference's host gather
``gather_docs``, bit for bit (fp16 -> fp32 widening is exact, and the scale
multiply is the same fp32 product).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import artifacts, layout_arrays
from repro.core.pool import pool_corpus as ref_pool_corpus
from repro.kernels.gather_pack.ref import gather_pack_ref as jax_ref
from repro.storage import layout as ref_layout
from repro_torch import convert
from repro_torch.core.rerank import pack_tiles
from repro_torch.kernels.gather_pack import ops
from repro_torch.kernels.gather_pack.ref import gather_pack_ref
from repro_torch.storage.io_engine import StorageTier

DTYPES = {"float32": np.float32, "float16": np.float16, "int8": np.int8}


def pool_and_idx(r, k, t, d, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        pool = rng.integers(-128, 128, (r, d)).astype(np.int8)
    else:
        pool = rng.standard_normal((r, d)).astype(DTYPES[dtype])
    idx = rng.integers(-1, r, (k, t)).astype(np.int32)
    return pool, idx


def assert_matches_jax(pool, idx):
    ours = gather_pack_ref(torch.from_numpy(pool), torch.from_numpy(idx))
    want = np.asarray(jax_ref(jnp.asarray(pool), jnp.asarray(idx)))
    assert ours.dtype == torch.from_numpy(pool).dtype
    np.testing.assert_array_equal(ours.numpy(), want)


# -- the plain version against the reference's oracle -------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,k,t,d", [(500, 8, 32, 32), (100, 3, 7, 16),
                                     (64, 16, 8, 8)])
def test_plain_matches_reference(r, k, t, d, dtype):
    """The shapes of tests/test_kernels.py's gather_pack cases."""
    pool, idx = pool_and_idx(r, k, t, d, dtype, seed=r + k + t)
    assert_matches_jax(pool, idx)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_all_pad_row_and_empty_batch(dtype):
    pool, idx = pool_and_idx(50, 6, 9, 16, dtype, seed=1)
    idx[2] = -1                                   # a doc with no tokens
    assert_matches_jax(pool, idx)
    out = gather_pack_ref(torch.from_numpy(pool), torch.from_numpy(idx))
    assert not out[2].any()
    empty = gather_pack_ref(torch.from_numpy(pool),
                            torch.zeros((0, 9), dtype=torch.int32))
    assert tuple(empty.shape) == (0, 9, 16)


@settings(max_examples=15, deadline=None)
@given(r=st.integers(2, 200), k=st.integers(1, 12), t=st.integers(1, 24),
       seed=st.integers(0, 2**16))
def test_plain_hypothesis(r, k, t, seed):
    pool, idx = pool_and_idx(r, k, t, 8, "float32", seed)
    assert_matches_jax(pool, idx)


def test_op_on_cpu_takes_the_plain_version_and_counts_no_launch():
    pool, idx = pool_and_idx(40, 5, 7, 12, "float16", seed=2)
    before = ops.gather_pack.launches
    out = ops.gather_pack(torch.from_numpy(pool), torch.from_numpy(idx))
    want = gather_pack_ref(torch.from_numpy(pool), torch.from_numpy(idx))
    assert torch.equal(out, want)
    assert ops.gather_pack.launches == before


# -- the device arena against the reference's host gather ---------------------

def ref_layouts():
    """(name, reference layout) for the three kinds the rerank reads."""
    c, _, ragged = artifacts()
    scales = np.array([np.abs(b).max() if len(b) else 1.0 for b in c.bow],
                      np.float32) / 127
    fixed = ref_layout.pack(c.cls, ref_pool_corpus(c.bow, 8, seed=0),
                            dtype=np.float16, mode="fixed_stride", pool_k=8)
    int8 = ref_layout.pack(c.cls, c.bow, dtype=np.int8, scales=scales)
    return {"ragged-fp16": ragged, "fixed-fp16": fixed, "ragged-int8": int8}


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("t_max", [48, 5, 20])
@pytest.mark.parametrize("kind", ["ragged-fp16", "fixed-fp16",
                                  "ragged-int8"])
def test_arena_tiles_equal_reference_gather(kind, t_max, coalesce):
    """Both read paths (the coalesced batch and the serial per-query read)
    stage raw rows; packed on the device and widened, they are the
    reference's padded fp32 gather bit for bit, ``t_max`` clipping
    included (the corpus's longest doc has 48 tokens)."""
    ref_lay = ref_layouts()[kind]
    lay = convert.layout_from_numpy(layout_arrays(ref_lay))
    assert lay.mode == ref_lay.mode
    rng = np.random.default_rng(t_max)
    lists = [rng.choice(lay.n_docs, 40, replace=False) for _ in range(3)]
    lists[1] = np.r_[lists[1], lists[0][:7]]        # duplicates across queries
    tier = StorageTier(lay, t_max=t_max, coalesce=coalesce, device="cpu",
                       io_chunk_docs=16)
    try:
        batch = tier.read_batch(lists)
        for b, ids in enumerate(lists):
            batch.ensure_query(b)
            arena, row_of, _ = batch.view(b)
            tiles, lens = pack_tiles(arena, [row_of[int(i)] for i in ids])
            _, want, want_lens = ref_layout.gather_docs(ref_lay, ids, t_max)
            got = tiles.float().numpy()
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            np.testing.assert_array_equal(lens.numpy(), want_lens)
    finally:
        tier.close()


def test_arena_holds_stored_dtype_rows_once():
    """The arena's pool is the union's clipped token rows in the stored
    dtype, doc after doc in arena order: nothing widened on the host, no
    pad rows, each duplicate stored once."""
    _, _, ref_lay = artifacts()
    lay = convert.layout_from_numpy(layout_arrays(ref_lay))
    tier = StorageTier(lay, t_max=30, device="cpu", io_chunk_docs=8)
    try:
        batch = tier.read_batch([[5, 9, 700], [9, 3]])
        batch.ensure_query(0)
        batch.ensure_query(1)
        arena = batch.arena
        plan = batch.plan
        assert arena.pool.dtype == torch.float16
        want_lens = np.minimum(lay.n_tokens[plan.arena_ids], 30)
        np.testing.assert_array_equal(arena.lens.numpy(), want_lens)
        np.testing.assert_array_equal(
            arena.first.numpy(), np.r_[0, np.cumsum(want_lens)[:-1]])
        assert arena.pool.shape == (want_lens.sum(), lay.d_bow)
        assert arena.scales is None and plan.n_unique == 4
    finally:
        tier.close()


def test_zero_candidates_score_nothing():
    """K = 0 packs and scores nothing and returns (0,)."""
    from repro_torch.core.rerank import _maxsim_np
    _, _, ref_lay = artifacts()
    lay = convert.layout_from_numpy(layout_arrays(ref_lay))
    tier = StorageTier(lay, t_max=48, device="cpu")
    try:
        arena = tier.read([1, 2]).arena
        before = ops.gather_pack.launches
        out = _maxsim_np(np.ones((4, lay.d_bow), np.float32), 4, arena, [])
        assert out.shape == (0,) and ops.gather_pack.launches == before
    finally:
        tier.close()
