"""The port's bit-vector path on the CPU, against the JAX package.

``kernels/bitsim``'s plain version against the reference's oracle and its
Pallas kernel (interpret mode) at ``tests/test_bitvec.py``'s shapes and
tolerance; the sign-bit packers, the resident ``BitTable`` and its
chunked ``bits_from_layout`` bit for bit; and the ``bitvec``/``cascade``
backends end to end around the reference's artifacts (ids up to adjacent
near-tie swaps, scores within 1e-5, bills exactly).
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (artifacts, assert_same_response, bits_arrays,
                           layout_arrays, run_both)
from repro.core import quantize as ref_quantize
from repro.kernels.bitsim.bitsim import bitsim_pallas
from repro.kernels.bitsim.ref import bitsim_ref as jax_bitsim_ref
from repro.pipeline import PipelineConfig as RefConfig
from repro.storage import layout as ref_layout
from repro.storage.io_engine import StorageTier as RefTier
from repro_torch import convert
from repro_torch.core import quantize
from repro_torch.kernels.bitsim import ops as bitsim_ops
from repro_torch.kernels.bitsim.ref import bitsim_ref
from repro_torch.pipeline import PipelineConfig
from repro_torch.storage import layout
from repro_torch.storage.io_engine import StorageTier

TOL = 1e-4
LANES = ("uint8", "uint16", "uint32")

BITSIM_SHAPES = [
    (24, 37, 64, 32, 16), (5, 9, 17, 128, 8), (1, 1, 1, 32, 16),
    (8, 64, 33, 64, 16), (16, 50, 12, 96, 8),
]


def bitsim_inputs(lq, k, t, d, seed, lanes="uint32"):
    r = np.random.default_rng(seed)
    q = r.standard_normal((lq, d)).astype(np.float32)
    qm = (r.random(lq) > 0.2).astype(np.float32)
    packed = ref_quantize.to_uint32_lanes(ref_quantize.binary_pack(
        r.standard_normal((k, t, d)).astype(np.float32), dtype=lanes))
    lens = r.integers(1, t + 1, k).astype(np.int32)
    if k > 1:
        lens[-1] = 0                   # a zero-length doc: -1e30 * sum(qm)
    return q, qm, packed, lens


def torch_args(q, qm, packed, lens):
    return (torch.from_numpy(q), torch.from_numpy(qm),
            torch.from_numpy(packed.view(np.int32)), torch.from_numpy(lens))


@pytest.mark.parametrize("lq,k,t,d,bk", BITSIM_SHAPES)
def test_bitsim_plain_matches_reference(lq, k, t, d, bk):
    q, qm, packed, lens = bitsim_inputs(lq, k, t, d, seed=lq * 1000 + k)
    ours = bitsim_ref(*torch_args(q, qm, packed, lens)).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(qm), jnp.asarray(packed),
             jnp.asarray(lens))
    oracle = np.asarray(jax_bitsim_ref(*jargs, d=d))
    kernel = np.asarray(bitsim_pallas(*jargs, d=d, block_docs=bk))
    np.testing.assert_allclose(ours, oracle, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, kernel, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lanes", LANES)
def test_bitsim_takes_any_lane_dtype_re_viewed(lanes):
    """uint8/uint16 tables re-viewed as 32-bit lanes score as uint32 ones;
    W = 2 with D = 40 leaves 24 pad bits that must never count."""
    q, qm, packed, lens = bitsim_inputs(7, 33, 20, 40, seed=3, lanes=lanes)
    assert packed.shape[-1] == 2
    _, _, packed32, _ = bitsim_inputs(7, 33, 20, 40, seed=3)
    np.testing.assert_array_equal(packed, packed32)
    ours = bitsim_ref(*torch_args(q, qm, packed, lens)).numpy()
    oracle = np.asarray(jax_bitsim_ref(jnp.asarray(q), jnp.asarray(qm),
                                       jnp.asarray(packed),
                                       jnp.asarray(lens), d=40))
    np.testing.assert_allclose(ours, oracle, rtol=TOL, atol=TOL)


def test_bitsim_op_on_cpu_takes_plain_version_and_launches_nothing():
    bitsim_ops.bitsim.launches = 0
    args = torch_args(*bitsim_inputs(8, 10, 20, 32, seed=1))
    torch.testing.assert_close(bitsim_ops.bitsim(*args), bitsim_ref(*args),
                               rtol=0, atol=0)
    uint = (*args[:2], args[2].view(torch.uint32), args[3])
    torch.testing.assert_close(bitsim_ops.bitsim(*uint), bitsim_ref(*args),
                               rtol=0, atol=0)
    assert bitsim_ops.bitsim.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        bitsim_ops.bitsim(torch.empty(2, 32), torch.empty(2),
                          torch.empty(4, 3, 1, dtype=torch.int32,
                                      device="meta"),
                          torch.empty(4, dtype=torch.int32))


# -- core/quantize.py ---------------------------------------------------------

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("d", [32, 40, 48, 100])
def test_sign_packers_are_bit_identical(lanes, d):
    x = np.random.default_rng(d).standard_normal((3, 7, d)).astype(np.float32)
    ours = quantize.binary_pack(x, dtype=lanes)
    ref = ref_quantize.binary_pack(x, dtype=lanes)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(quantize.binary_unpack(ours, d),
                                  ref_quantize.binary_unpack(ref, d))
    np.testing.assert_array_equal(quantize.to_uint32_lanes(ours),
                                  ref_quantize.to_uint32_lanes(ref))
    with pytest.raises(ValueError):
        quantize.binary_pack(x, dtype="int32")


# -- storage/layout.py: BitTable ---------------------------------------------

@pytest.mark.parametrize("lanes", LANES)
def test_pack_bits_and_gather_are_bit_identical(lanes):
    r = np.random.default_rng(9)
    bows = [r.standard_normal((t, 48)).astype(np.float32)
            for t in (3, 7, 0, 12, 1)]
    ours = layout.pack_bits(bows, dtype=lanes)
    ref = ref_layout.pack_bits(bows, dtype=lanes)
    np.testing.assert_array_equal(ours.packed, ref.packed)
    np.testing.assert_array_equal(ours.starts, ref.starts)
    assert (ours.n_docs, ours.nbytes, ours.d_bow) == \
        (ref.n_docs, ref.nbytes, ref.d_bow)
    np.testing.assert_array_equal(ours.doc(3), ref.doc(3))
    for ids, t_max in (([2, 0, 3, 4], 8), ([3, 3, 1], 5), ([], 4)):
        a, la = ours.gather(ids, t_max)
        b, lb = ref.gather(ids, t_max)
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    empty = layout.pack_bits([], dtype=lanes, d_bow=48)
    assert empty.n_docs == 0 and empty.packed.shape == \
        ref_layout.pack_bits([], dtype=lanes, d_bow=48).packed.shape


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("chunk_docs", [7, layout.CHUNK_DOCS])
def test_bits_from_layout_is_bit_identical(lanes, chunk_docs):
    _, _, ref_lay = artifacts()
    ours = layout.bits_from_layout(
        convert.layout_from_numpy(layout_arrays(ref_lay)), dtype=lanes,
        chunk_docs=chunk_docs)
    ref = ref_layout.bits_from_layout(ref_lay, dtype=lanes)
    np.testing.assert_array_equal(ours.packed, ref.packed)
    np.testing.assert_array_equal(ours.starts, ref.starts)
    assert ours.packed.dtype == ref.packed.dtype


def test_bits_from_int8_layout_with_scales_is_bit_identical():
    """The chunked decode applies per-doc dequant scales token by token."""
    c, _, _ = artifacts()
    scales = np.array([np.abs(b).max() if len(b) else 1.0 for b in c.bow],
                      np.float32) / 127
    ref_lay = ref_layout.pack(c.cls, c.bow, dtype=np.int8, scales=scales)
    assert ref_lay.scales is not None
    ours = layout.bits_from_layout(
        convert.layout_from_numpy(layout_arrays(ref_lay)), chunk_docs=50)
    ref = ref_layout.bits_from_layout(ref_lay)
    np.testing.assert_array_equal(ours.packed, ref.packed)


def test_bow_rows_are_the_blob_tokens():
    c, _, ref_lay = artifacts()
    lay = convert.layout_from_numpy(layout_arrays(ref_lay))
    rows = layout.bow_rows(lay, 5, 9)
    want = np.concatenate([ref_layout.unpack_doc(ref_lay, i)[1]
                           for i in range(5, 9)])
    np.testing.assert_array_equal(rows.astype(np.float32), want)
    assert layout.token_scales(lay, 5, 9) is None


# -- storage/io_engine.py ----------------------------------------------------

@pytest.mark.parametrize("stack", ["espn", "dram", "mmap"])
def test_read_bits_and_resident_bytes_match_reference(stack):
    _, _, ref_lay = artifacts()
    ref_bits = ref_layout.bits_from_layout(ref_lay, dtype="uint16")
    budget = ref_lay.nbytes // 4 if stack == "mmap" else None
    ref = RefTier(ref_lay, stack=stack, mem_budget_bytes=budget,
                  bits=ref_bits, t_max=48)
    ours = StorageTier(convert.layout_from_numpy(layout_arrays(ref_lay)),
                       stack=stack, mem_budget_bytes=budget, t_max=48,
                       bits=convert.bit_table_from_numpy(
                           bits_arrays(ref_bits)))
    try:
        assert ours.memory_resident_bytes() == ref.memory_resident_bytes()
        ids = np.array([4, 1100, 3, 4])
        for got, want in zip(ours.read_bits(ids), ref.read_bits(ids)):
            np.testing.assert_array_equal(got, want)
        bare = StorageTier(ours.layout, stack=stack, mem_budget_bytes=budget)
        with pytest.raises(RuntimeError, match="BitTable"):
            bare.read_bits(ids)
        assert bare.memory_resident_bytes() < ours.memory_resident_bytes()
        bare.close()
    finally:
        ref.close()
        ours.close()


# -- the bitvec and cascade backends -----------------------------------------

@pytest.mark.parametrize("bit_filter", [8, 60, 200])
def test_bitvec_backend_matches_reference(bit_filter):
    """A narrow filter, one exactly as wide as the candidates, and one wider
    (every candidate survives)."""
    assert_same_response(*run_both("bitvec", bit_filter=bit_filter))


def test_bitvec_serial_io_and_uint8_lanes_match_reference():
    assert_same_response(*run_both("bitvec", io_coalesce=False,
                                   bit_dtype="uint8", bit_filter=12))


@pytest.mark.parametrize("width,filt", [(40, 8), (0, 30)])
def test_cascade_backend_matches_reference(width, filt):
    assert_same_response(*run_both("cascade", cascade_candidates=width,
                                   cascade_filter=filt))


def test_bitvec_knobs_match_reference_cli_and_dicts():
    argv = ["--mode", "bitvec", "--bit-filter", "48", "--bit-dtype", "uint8",
            "--cascade-filter", "9", "--cascade-candidates", "77"]
    ours = PipelineConfig.from_cli(PipelineConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(argv))
    ref = RefConfig.from_cli(RefConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(argv))
    for f in ("mode", "bit_filter", "cascade_filter", "cascade_candidates"):
        assert getattr(ours.retrieval, f) == getattr(ref.retrieval, f)
    assert ours.storage.bit_dtype == ref.storage.bit_dtype == "uint8"
    assert PipelineConfig.from_dict(ours.to_dict()) == ours
    e, r = ours.retrieval.to_espn_config(), ref.retrieval.to_espn_config()
    for f in ("bit_filter", "fde_brute_threshold", "cascade_filter",
              "cascade_candidates"):
        assert getattr(e, f) == getattr(r, f)
