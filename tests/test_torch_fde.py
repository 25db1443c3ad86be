"""The port's FDE path on the CPU, against the JAX package.

``kernels/fdescan``'s plain version against the reference's oracle and its
Pallas kernel (interpret mode) at ``tests/test_fde.py``'s shapes and
tolerance; the FDE encoder (the same numpy-drawn planes and projection,
encodings within 1e-5 relative) and ``fde_from_layout`` (fp16 tables equal
up to 1 ulp); and the ``fde`` backend in both branches end to end around
the reference's artifacts (ids up to adjacent near-tie swaps, scores within
1e-5, bills exactly).

The encodings are held within a tolerance, not bitwise: a SimHash sign
test sums 32 products in another order in numpy and in PyTorch, so a token
within rounding of a hyperplane could land in another bucket (none does on
these inputs), and the bucket sums and the float64 projection are taken in
another order.
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (artifacts, assert_same_response, fde_arrays,
                           index_arrays, layout_arrays, run_both)
from repro.core import fde as ref_fde
from repro.core.ivf import build_ivf as ref_build_ivf
from repro.kernels.fdescan.fdescan import fdescan_pallas
from repro.kernels.fdescan.ref import fdescan_ref as jax_fdescan_ref
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.storage.io_engine import StorageTier as RefTier
from repro_torch import convert
from repro_torch.core import fde
from repro_torch.core.ivf import build_ivf
from repro_torch.kernels.fdescan import ops as fdescan_ops
from repro_torch.kernels.fdescan.ref import fdescan_ref
from repro_torch.pipeline import Pipeline, PipelineConfig
from repro_torch.storage.io_engine import StorageTier

TOL = 1e-4
ENC_RTOL = 1e-5

FDESCAN_SHAPES = [
    (1, 1, 32, 128), (8, 300, 256, 256), (3, 37, 130, 64),
    (24, 1000, 128, 256), (5, 513, 100, 128),
]

FDE_CONFIGS = [
    dict(k_sim=3, r_reps=16, d_final=256),          # the retrieval defaults
    dict(k_sim=3, r_reps=4, d_final=0),             # raw concatenation
    dict(k_sim=2, r_reps=5, d_final=64, fill_empty=False, seed=7),
]


def assert_close_rel(ours, ref, rtol=ENC_RTOL):
    """Elementwise within ``rtol`` of the larger of |ref| and the array's
    largest magnitude (entries near zero carry the row's rounding)."""
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(ours, np.float64), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("b,n,d,bk", FDESCAN_SHAPES)
def test_fdescan_plain_matches_reference(b, n, d, bk):
    r = np.random.default_rng(b * 1000 + n)
    q = r.standard_normal((b, d)).astype(np.float32)
    docs = r.standard_normal((n, d)).astype(np.float16)
    ours = fdescan_ref(torch.from_numpy(q), torch.from_numpy(docs)).numpy()
    oracle = np.asarray(jax_fdescan_ref(jnp.asarray(q), jnp.asarray(docs)))
    kernel = np.asarray(fdescan_pallas(jnp.asarray(q), jnp.asarray(docs),
                                       block_docs=bk))
    assert ours.shape == kernel.shape == (b, n)
    np.testing.assert_allclose(ours, oracle, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, kernel, rtol=TOL, atol=TOL)


def test_fdescan_op_on_cpu_takes_plain_version_and_launches_nothing():
    fdescan_ops.fdescan.launches = 0
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 64, generator=g)
    for docs in (torch.randn(50, 64, generator=g).half(),
                 torch.randn(50, 64, generator=g)):
        torch.testing.assert_close(fdescan_ops.fdescan(q, docs),
                                   fdescan_ref(q, docs), rtol=0, atol=0)
    assert fdescan_ops.fdescan.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fdescan_ops.fdescan(q, torch.empty(5, 64, device="meta"))


# -- core/fde.py --------------------------------------------------------------

def bows_of(seed, lens, d=32):
    r = np.random.default_rng(seed)
    return [r.standard_normal((t, d)).astype(np.float32) for t in lens]


@pytest.mark.parametrize("kw", FDE_CONFIGS)
def test_encoder_draws_the_reference_randomness(kw):
    cfg = fde.FDEConfig(d_bow=32, **kw)
    ours, ref = fde.FDEEncoder(cfg, "cpu"), ref_fde.FDEEncoder(
        ref_fde.FDEConfig(d_bow=32, **kw))
    np.testing.assert_array_equal(ours.planes.numpy(),
                                  ref.planes.reshape(-1, 32))
    if cfg.d_final:
        np.testing.assert_array_equal(ours.proj.numpy(), ref.proj)
    else:
        assert ours.proj is None and ref.proj is None
    assert (cfg.d_raw, cfg.d_fde) == (ref.cfg.d_raw, ref.cfg.d_fde)


@pytest.mark.parametrize("kw", FDE_CONFIGS)
def test_encode_docs_and_queries_match_reference(kw):
    """Docs of 0, 1 and many tokens (an empty doc is all zeros; a one-token
    doc fills every bucket from its one non-empty bucket), and queries."""
    bows = bows_of(1, [0, 1, 2, 5, 17, 40, 3, 60])
    ours = fde.FDEEncoder(fde.FDEConfig(d_bow=32, **kw), "cpu")
    ref = ref_fde.FDEEncoder(ref_fde.FDEConfig(d_bow=32, **kw))
    got = ours.encode_docs(bows, chunk=3)
    assert got.dtype == torch.float32
    assert_close_rel(got.numpy(), ref.encode_docs(bows))
    r = np.random.default_rng(2)
    q_bow = r.standard_normal((6, 24, 32)).astype(np.float32)
    q_lens = np.array([24, 1, 0, 13, 24, 7])
    assert_close_rel(ours.encode_queries(q_bow, q_lens).numpy(),
                     ref.encode_queries(q_bow, q_lens))


def test_fill_empty_takes_the_first_nearest_bucket():
    """With k_sim=3 a bucket has three neighbours at Hamming distance 1;
    the backfill copies the lowest-numbered non-empty one, as np.argmin
    does. One token per doc, no projection: the raw buckets are compared
    exactly."""
    cfg = dict(k_sim=3, r_reps=6, d_final=0)
    bows = bows_of(4, [1, 2, 2, 3, 1])
    got = fde.FDEEncoder(fde.FDEConfig(d_bow=32, **cfg),
                          "cpu").encode_docs(bows)
    want = ref_fde.FDEEncoder(ref_fde.FDEConfig(d_bow=32, **cfg)
                              ).encode_docs(bows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk_docs", [100, fde.CHUNK_DOCS])
@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_fde_from_layout_matches_reference(chunk_docs, dtype):
    _, _, ref_lay = artifacts()
    cfg = dict(d_bow=ref_lay.d_bow, k_sim=3, r_reps=16, d_final=256)
    ours = fde.fde_from_layout(
        convert.layout_from_numpy(layout_arrays(ref_lay)),
        fde.FDEConfig(**cfg), dtype=dtype, chunk_docs=chunk_docs,
        device="cpu")
    ref = ref_fde.fde_from_layout(ref_lay, ref_fde.FDEConfig(**cfg),
                                  dtype=dtype)
    assert ours.n_docs == ref.n_docs and ours.nbytes == ref.nbytes
    assert ours.matches(fde.FDEConfig(**cfg), dtype)
    got = ours.vecs.numpy()
    assert got.dtype == ref.vecs.dtype
    if dtype == "float16":
        # the fp32 encodings agree to ~1e-7, so the fp16 roundings agree to
        # within one unit in the last place
        ulp = np.abs(got.view(np.int16).astype(np.int32)
                     - ref.vecs.view(np.int16).astype(np.int32))
        assert ulp.max() <= 1
    else:
        assert_close_rel(got, ref.vecs)


def test_build_fde_table_matches_reference():
    bows = bows_of(5, [3, 0, 9, 30])
    cfg = dict(d_bow=32, k_sim=3, r_reps=8, d_final=128)
    ours = fde.build_fde_table(bows, fde.FDEConfig(**cfg), device="cpu")
    ref = ref_fde.build_fde_table(bows, ref_fde.FDEConfig(**cfg))
    got = ours.vecs.numpy()
    ulp = np.abs(got.view(np.int16).astype(np.int32)
                 - ref.vecs.view(np.int16).astype(np.int32))
    assert ulp.max() <= 1


# -- storage/io_engine.py and the backend's resident bytes -------------------

@pytest.mark.parametrize("stack", ["espn", "dram"])
def test_resident_bytes_match_reference(stack):
    _, _, ref_lay = artifacts()
    ref_table = ref_fde.fde_from_layout(
        ref_lay, ref_fde.FDEConfig(d_bow=ref_lay.d_bow, r_reps=4, d_final=64))
    ref = RefTier(ref_lay, stack=stack, fde=ref_table)
    ours = StorageTier(convert.layout_from_numpy(layout_arrays(ref_lay)),
                       stack=stack, fde=convert.fde_table_from_numpy(
                           fde_arrays(ref_table), "cpu"))
    try:
        assert ours.memory_resident_bytes() == ref.memory_resident_bytes()
    finally:
        ref.close()
        ours.close()


@pytest.mark.parametrize("threshold", [100_000, 0])
def test_candidate_gen_bytes_match_reference(threshold):
    c, index, ref_lay = artifacts()
    ref_cfg, port_cfg = RefConfig(), PipelineConfig()
    for cfg in (ref_cfg, port_cfg):
        cfg.retrieval.mode = "fde"
        cfg.retrieval.fde_brute_threshold = threshold
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=ref_lay) as ref:
        with Pipeline.from_artifacts(
                port_cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(ref_lay)),
                fde=convert.fde_table_from_numpy(fde_arrays(ref.tier.fde),
                                                 "cpu"),
                device="cpu") as port:
            assert (port.backend.candidate_gen_bytes()
                    == ref.backend.candidate_gen_bytes())
            assert (port.tier.memory_resident_bytes()
                    == ref.tier.memory_resident_bytes())
            assert (port.backend.fde_index is None) == (threshold > 0)


def test_ivf_over_fdes_agrees_with_reference():
    """The port's own IVF over the FDEs (k-means sums in another order)
    puts nearly every doc in the reference's cell."""
    _, _, ref_lay = artifacts()
    table = ref_fde.fde_from_layout(
        ref_lay, ref_fde.FDEConfig(d_bow=ref_lay.d_bow))
    vecs = np.asarray(table.vecs, np.float32)
    ref = ref_build_ivf(vecs, ncells=16, iters=4)
    ours = build_ivf(vecs, ncells=16, iters=4, device="cpu")

    def cell_of(ids):
        ids = np.asarray(ids)
        out = np.full(len(vecs), -1)
        for c, row in enumerate(ids):
            out[row[row >= 0]] = c
        return out
    agree = np.mean(cell_of(ours.cell_ids.numpy()) == cell_of(ref.cell_ids))
    assert agree >= 0.99, agree


# -- the fde backend ---------------------------------------------------------

@pytest.mark.parametrize("threshold", [100_000, 0])
def test_fde_backend_matches_reference(threshold):
    """The brute scan, and the IVF over the FDEs (threshold 0)."""
    assert_same_response(*run_both("fde", fde_brute_threshold=threshold))


def test_fde_partial_rerank_and_serial_io_match_reference():
    assert_same_response(*run_both("fde", io_coalesce=False,
                                   rerank_count=16, k_candidates=45))


def test_fde_knobs_match_reference_cli():
    argv = ["--mode", "fde", "--fde-k-sim", "2", "--fde-reps", "5",
            "--fde-d-final", "0", "--fde-seed", "3",
            "--fde-brute-threshold", "10", "--fde-dtype", "float32"]
    ours = PipelineConfig.from_cli(PipelineConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(argv))
    ref = RefConfig.from_cli(RefConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(argv))
    for f in ("fde_k_sim", "fde_reps", "fde_d_final", "fde_seed",
              "fde_brute_threshold"):
        assert getattr(ours.retrieval, f) == getattr(ref.retrieval, f)
    assert ours.storage.fde_dtype == ref.storage.fde_dtype == "float32"
    a, b = ours.retrieval.to_fde_config(32), ref.retrieval.to_fde_config(32)
    assert (a.d_bow, a.k_sim, a.r_reps, a.d_final, a.fill_empty, a.seed) == \
        (b.d_bow, b.k_sim, b.r_reps, b.d_final, b.fill_empty, b.seed)
