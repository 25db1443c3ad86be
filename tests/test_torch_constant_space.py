"""The port's constant-space path on the CPU, against the JAX package:
token pooling (``core/pool.py``), the ``fixed_stride`` layout, its carry
across from the reference's artifacts, and the ``cspn`` backend.

Pooling and packing are numpy in both packages and must agree bit for bit.
The query path is held as ``tests/_torch_parity.py`` holds the ragged one:
ids equal up to adjacent swaps of scores within 1e-5, scores within 1e-5,
the simulated bill, the storage counters and the resident bytes exactly
equal. Both packages serve the reference's fixed layout; the ragged layout
is not the yardstick (the reference itself differs between the two modes
by up to 9.5e-7 in espn scores, ROADMAP Queue C).
"""
import argparse
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_parity import (artifacts, assert_same_response, configs,
                           index_arrays, layout_arrays)
from repro.core.pool import pool_corpus as ref_pool_corpus
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import persist as ref_persist
from repro.storage import layout as ref_layout
from repro_torch import convert
from repro_torch.core.pool import pool_corpus, pool_tokens
from repro_torch.pipeline import Pipeline, PipelineConfig
from repro_torch.storage import layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_K = 8


@functools.lru_cache(maxsize=1)
def pooled():
    """The parity corpus pooled to POOL_K tokens a doc (its docs hold 0 to
    48 tokens, so every branch of the pooling runs), and the reference's
    fixed layout of it."""
    c, _, _ = artifacts()
    bow = ref_pool_corpus(c.bow, POOL_K, seed=0)
    return bow, ref_layout.pack(c.cls, bow, dtype=np.float16,
                                mode="fixed_stride", pool_k=POOL_K)


# -- core/pool.py --------------------------------------------------------------

@pytest.mark.parametrize("k,seed", [(POOL_K, 0), (3, 7), (32, 1)])
def test_pool_corpus_is_bit_identical(k, seed):
    c, _, _ = artifacts()
    bow = c.bow + [np.zeros((0, c.bow[0].shape[1]), np.float32)]
    ours = pool_corpus(bow, k, seed=seed)
    want = ref_pool_corpus(bow, k, seed=seed)
    assert len(ours) == len(want)
    for a, b in zip(ours, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_pool_rejects_non_positive_k():
    with pytest.raises(ValueError, match="positive"):
        pool_tokens(np.zeros((4, 8), np.float32), 0)


# -- storage/layout.py fixed_stride --------------------------------------------

def test_fixed_pack_is_the_reference_blob():
    c, _, _ = artifacts()
    bow, ref = pooled()
    ours = layout.pack(c.cls, bow, dtype=np.float16, mode="fixed_stride",
                       pool_k=POOL_K)
    np.testing.assert_array_equal(ours.blob, ref.blob)
    assert ours.meta_nbytes == ref.meta_nbytes == 0
    assert (ours.stride_blocks, ours.pool_k, ours.mode) == \
        (ref.stride_blocks, ref.pool_k, ref.mode)
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    np.testing.assert_array_equal(ours.n_tokens, ref.n_tokens)
    ids = [0, 5, 5, 1199]
    assert ours.blocks_for(ids) == ref.blocks_for(ids)
    assert ours.doc_bytes(3) == ref.doc_bytes(3)
    # the stored rows read back as the reference's
    np.testing.assert_array_equal(
        layout.bow_rows(ours, 7, 9).astype(np.float32),
        np.concatenate([ref_layout.unpack_doc(ref, i)[1] for i in (7, 8)]))


def test_fixed_pack_rejects_unpooled_docs_and_bad_pool_k():
    rng = np.random.default_rng(0)
    cls = rng.standard_normal((3, 16)).astype(np.float32)
    bows = [rng.standard_normal((t, 8)).astype(np.float32)
            for t in (POOL_K, POOL_K, POOL_K - 1)]
    with pytest.raises(ValueError, match="pool"):
        layout.pack(cls, bows, mode="fixed_stride", pool_k=POOL_K)
    with pytest.raises(ValueError):
        layout.pack(cls, bows[:1], mode="fixed_stride", pool_k=0)
    with pytest.raises(ValueError, match="layout mode"):
        layout.EmbeddingLayout(blob=np.zeros(0, np.uint8), offsets=None,
                               n_tokens=None, d_cls=0, d_bow=8,
                               dtype=np.dtype(np.float16), scales=None,
                               mode="columnar")


def test_fixed_layout_carries_across_from_the_reference_npz(tmp_path):
    """The reference saves a fixed layout with no offset or token tables;
    ``convert`` recomputes them from the stride."""
    _, ref = pooled()
    path = str(tmp_path / "layout.npz")
    ref_persist.save_layout(ref, path)
    z = np.load(path)
    assert "offsets" not in z.files and "n_tokens" not in z.files
    ours = convert.layout_from_numpy(z)
    assert ours.mode == "fixed_stride" and ours.meta_nbytes == 0
    assert (ours.stride_blocks, ours.pool_k) == (ref.stride_blocks, POOL_K)
    np.testing.assert_array_equal(ours.blob, ref.blob)
    np.testing.assert_array_equal(ours.offsets, ref.offsets)
    np.testing.assert_array_equal(ours.n_tokens, ref.n_tokens)


# -- the query path on the fixed layout ----------------------------------------

def run_fixed(mode):
    """Both packages around the same index and the reference's fixed
    layout: responses, storage counters and resident bytes."""
    c, index, _ = artifacts()
    _, ref_lay = pooled()
    ref_cfg, port_cfg = configs(mode)
    for cfg in (ref_cfg, port_cfg):
        cfg.storage.layout_mode, cfg.storage.pool_k = "fixed_stride", POOL_K
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=ref_lay) as ref:
        r = ref.search(*q)
        r_stats, r_res = dict(ref.tier.stats), ref.tier.memory_resident_bytes()
        with Pipeline.from_artifacts(
                port_cfg, index=convert.ivf_index_from_numpy(
                    index_arrays(index), "cpu"),
                layout=convert.layout_from_numpy(layout_arrays(ref_lay)),
                device="cpu") as port:
            assert port.layout.mode == "fixed_stride"
            p = port.search(*q)
            p_stats = dict(port.tier.stats)
            p_res = port.tier.memory_resident_bytes()
    return r, p, r_stats, p_stats, r_res, p_res


@pytest.mark.parametrize("mode", ["cspn", "espn", "gds"])
def test_backend_on_fixed_layout_matches_reference(mode):
    r, p, r_stats, p_stats, r_res, p_res = run_fixed(mode)
    assert_same_response(r, p, r_stats, p_stats)
    assert p_res == r_res


# -- config, CLI and build -----------------------------------------------------

def test_build_rejects_fixed_stride_without_pool_k():
    cfg = PipelineConfig()
    cfg.corpus.n_docs = 50
    cfg.storage.layout_mode = "fixed_stride"
    cfg.storage.pool_k = 0
    with pytest.raises(ValueError, match="pool_k"):
        Pipeline.build(cfg, device="cpu")


def test_cli_round_trips_pool_flags():
    ap = PipelineConfig.add_cli_args(argparse.ArgumentParser())
    cfg = PipelineConfig.from_cli(ap.parse_args(
        ["--mode", "cspn", "--layout-mode", "fixed_stride", "--pool-k",
         "16", "--pool-seed", "3"]))
    assert cfg.retrieval.mode == "cspn"
    assert cfg.storage.layout_mode == "fixed_stride"
    assert (cfg.storage.pool_k, cfg.storage.pool_seed) == (16, 3)
    assert PipelineConfig.from_dict(cfg.to_dict()).storage.pool_k == 16


def test_build_pools_and_packs_fixed_on_cpu():
    """The port's own build path: every doc pooled to pool_k tokens, one
    block stride for all, the cspn batch ranked."""
    cfg = PipelineConfig()
    cfg.corpus.n_docs, cfg.corpus.n_queries = 600, 6
    cfg.corpus.n_clusters, cfg.index.ncells = 12, 12
    cfg.retrieval.mode = "cspn"
    cfg.retrieval.nprobe, cfg.retrieval.k_candidates = 6, 40
    cfg.storage.layout_mode, cfg.storage.pool_k = "fixed_stride", POOL_K
    with Pipeline.build(cfg, device="cpu") as pipe:
        lay = pipe.layout
        assert lay.mode == "fixed_stride" and lay.meta_nbytes == 0
        assert (lay.n_tokens == POOL_K).all()
        assert lay.offsets[:, 1].min() == lay.offsets[:, 1].max()
        assert pipe.tier.memory_resident_bytes() == 0
        ev = pipe.evaluate()
    assert ev["mrr@10"] > 0.5


def test_cli_runs_cspn_on_fixed_layout_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.pipeline", "--docs", "400",
         "--queries", "4", "--ncells", "8", "--nprobe", "4", "--k", "30",
         "--mode", "cspn", "--layout-mode", "fixed_stride", "--pool-k", "8",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr
    assert "MRR@10=" in out.stdout
