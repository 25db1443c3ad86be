"""The port's query path against the JAX reference, end to end on the CPU.

Both packages run around the SAME index and layout: the reference builds
them, ``repro_torch.convert`` carries them across, and each package's
``Pipeline.from_artifacts`` serves the same queries. For ``espn`` and the
four direct backends the port must give the reference's ranked ids, its
scores within 1e-5, and its simulated ``LatencyBreakdown`` exactly.

Scores are fp32 sums taken in another order by XLA and by PyTorch, so two
candidates whose aggregate scores lie within 1e-5 of each other may come
out in either order; such an adjacent swap is the one difference allowed
in the ranked ids.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.ivf import build_ivf as ref_build_ivf
from repro.data.synthetic import make_corpus as ref_make_corpus
from repro.pipeline import Pipeline as RefPipeline
from repro.pipeline import PipelineConfig as RefConfig
from repro.storage.layout import pack as ref_pack
from repro_torch import convert
from repro_torch.data.synthetic import make_corpus
from repro_torch.pipeline import Pipeline, PipelineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("espn", "gds", "mmap", "swap", "dram")
SCORE_TOL = 1e-5


@functools.lru_cache(maxsize=1)
def artifacts():
    c = ref_make_corpus(n_docs=1200, n_queries=12, n_clusters=16,
                        mean_len=20, max_len=48, seed=3)
    index = ref_build_ivf(c.cls, ncells=24, iters=4)
    layout = ref_pack(c.cls, c.bow, dtype=np.float16)
    return c, index, layout


def index_arrays(index):
    return dict(centroids=np.asarray(index.centroids),
                cell_ids=np.asarray(index.cell_ids),
                cell_vecs=np.asarray(index.cell_vecs),
                cell_scale=(np.asarray(index.cell_scale)
                            if index.cell_scale is not None else None),
                cell_sizes=index.cell_sizes, n_docs=index.n_docs,
                quant=index.quant)


def layout_arrays(layout):
    return dict(blob=layout.blob, offsets=layout.offsets,
                n_tokens=layout.n_tokens, d_cls=layout.d_cls,
                d_bow=layout.d_bow, dtype=str(layout.dtype),
                scales=layout.scales, block=layout.block)


def configs(mode, **retrieval):
    kw = dict(mode=mode, nprobe=10, k_candidates=60, prefetch_step=0.3,
              **retrieval)
    ref, port = RefConfig(), PipelineConfig()
    for cfg in (ref, port):
        cfg.storage.t_max = 48
        for k, v in kw.items():
            setattr(cfg.retrieval, k, v)
    return ref, port


def assert_same_ranking(ref_out, port_out):
    """ids equal up to adjacent swaps of scores within SCORE_TOL; scores
    within SCORE_TOL position by position."""
    a, b = np.asarray(ref_out.doc_ids), np.asarray(port_out.doc_ids)
    sa, sb = np.asarray(ref_out.scores), np.asarray(port_out.scores)
    assert a.shape == b.shape
    np.testing.assert_allclose(sb, sa, rtol=0, atol=SCORE_TOL)
    for j in np.nonzero(a != b)[0]:
        # the only allowed difference: a near-tie swapped with a neighbour
        near = [n for n in (j - 1, j + 1) if 0 <= n < len(a)
                and a[n] == b[j] and abs(sa[n] - sa[j]) <= SCORE_TOL]
        assert near, f"rank {j}: ref id {a[j]} vs port id {b[j]}"


def run_both(mode, io_coalesce=True, **retrieval):
    """Both packages' responses and storage-tier counters for one batch."""
    c, index, layout = artifacts()
    ref_cfg, port_cfg = configs(mode, **retrieval)
    ref_cfg.storage.io_coalesce = port_cfg.storage.io_coalesce = io_coalesce
    q = (c.queries_cls, c.queries_bow, c.query_lens)
    with RefPipeline.from_artifacts(ref_cfg, index=index,
                                    layout=layout) as ref:
        r = ref.search(*q)
        r_stats = dict(ref.tier.stats)
    with Pipeline.from_artifacts(
            port_cfg, index=convert.ivf_index_from_numpy(
                index_arrays(index), "cpu"),
            layout=convert.layout_from_numpy(layout_arrays(layout)),
            device="cpu") as port:
        p = port.search(*q)
        p_stats = dict(port.tier.stats)
    return r, p, r_stats, p_stats


def assert_same_response(r, p, r_stats, p_stats):
    assert len(r.ranked) == len(p.ranked)
    for ro, po in zip(r.ranked, p.ranked):
        assert ro.n_reranked == po.n_reranked
        assert ro.bow_bytes_read == po.bow_bytes_read
        assert_same_ranking(ro, po)
    assert p.breakdown.as_dict() == r.breakdown.as_dict()
    assert p_stats == r_stats


@pytest.mark.parametrize("mode", MODES)
def test_backend_matches_reference(mode):
    assert_same_response(*run_both(mode))


@pytest.mark.parametrize("mode", ["espn", "gds"])
def test_partial_rerank_and_serial_io_match_reference(mode):
    """Partial re-rank (top-R by CLS score) over the serial I/O path."""
    assert_same_response(*run_both(mode, io_coalesce=False, rerank_count=16))


def test_make_corpus_is_bit_identical():
    a = ref_make_corpus(n_docs=300, n_queries=5, n_clusters=8, seed=3)
    b = make_corpus(n_docs=300, n_queries=5, n_clusters=8, seed=3)
    for f in ("cls", "doc_lens", "queries_cls", "queries_bow", "query_lens"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(a.bow) == len(b.bow)
    for x, y in zip(a.bow, b.bow):
        np.testing.assert_array_equal(x, y)
    assert a.qrels == b.qrels


def test_build_without_device_needs_cuda():
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = PipelineConfig()
    cfg.corpus.n_docs = 50
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline.build(cfg)
    _, index, layout = artifacts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline.from_artifacts(
            cfg, index=convert.ivf_index_from_numpy(index_arrays(index),
                                                    "cpu"),
            layout=convert.layout_from_numpy(layout_arrays(layout)))


def test_unported_layout_mode_raises():
    cfg = PipelineConfig()
    cfg.corpus.n_docs = 50
    cfg.storage.layout_mode = "fixed_stride"
    with pytest.raises(NotImplementedError):
        Pipeline.build(cfg, device="cpu")


def test_build_and_evaluate_on_cpu():
    """The port's own build path (k-means included) end to end."""
    cfg = PipelineConfig()
    cfg.corpus.n_docs, cfg.corpus.n_queries = 800, 8
    cfg.corpus.n_clusters = 16
    cfg.index.ncells = 16
    cfg.retrieval.nprobe, cfg.retrieval.k_candidates = 8, 50
    with Pipeline.build(cfg, device="cpu") as pipe:
        ev = pipe.evaluate()
    assert ev["mrr@10"] > 0.5
    assert ev["breakdown_ms"]["total_s"] > 0


def test_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.pipeline", "--docs", "400",
         "--queries", "4", "--ncells", "8", "--nprobe", "4", "--k", "30",
         "--mode", "gds", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr
    assert "MRR@10=" in out.stdout
