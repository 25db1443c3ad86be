"""The port's query path against the JAX reference, end to end on the CPU.

Both packages run around the SAME index, layout and side tables (the
harness is ``tests/_torch_parity.py``). For every ported backend the port
must give the reference's ranked ids (adjacent near-tie swaps allowed), its
scores within 1e-5, and its simulated ``LatencyBreakdown`` exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (artifacts, assert_same_response, index_arrays,
                           layout_arrays, run_both)
from repro.data.synthetic import make_corpus as ref_make_corpus
from repro_torch import convert
from repro_torch.data.synthetic import make_corpus
from repro_torch.pipeline import Pipeline, PipelineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("espn", "gds", "mmap", "swap", "dram", "bitvec", "fde", "cascade")


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
    """Both of the reference's layout modes are ported; a mode that is
    neither raises before anything is packed."""
    cfg = PipelineConfig()
    cfg.corpus.n_docs = 50
    cfg.storage.layout_mode = "columnar"
    with pytest.raises(ValueError, match="unknown layout_mode"):
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
