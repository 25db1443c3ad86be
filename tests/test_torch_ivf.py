"""The port's IVF index against the JAX package's, on the CPU.

Search is held on the reference-built index, carried across by
``repro_torch.convert``: equal ids and scores within 1e-5 (fp32 products
summed in another order). ``build_ivf`` is held by assignment agreement and
recall, not bitwise: its k-means sums (``index_add_`` against
``segment_sum``) run in another order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as ref_ivf
from repro.core import maxsim as ref_core
from repro.data.synthetic import make_corpus
from repro_torch import convert
from repro_torch.core import ivf
from repro_torch.core.maxsim import rank, topk_stable

SCORE_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def corpus():
    return make_corpus(n_docs=1500, n_queries=16, n_clusters=16,
                       with_bow=False, seed=3)


@functools.lru_cache(maxsize=None)
def ref_index(quant):
    return ref_ivf.build_ivf(corpus().cls, ncells=32, iters=4, quant=quant)


def carried(index):
    return convert.ivf_index_from_numpy(dict(
        centroids=np.asarray(index.centroids),
        cell_ids=np.asarray(index.cell_ids),
        cell_vecs=np.asarray(index.cell_vecs),
        cell_scale=(np.asarray(index.cell_scale)
                    if index.cell_scale is not None else None),
        cell_sizes=index.cell_sizes, n_docs=index.n_docs,
        quant=index.quant), "cpu")


def test_topk_is_stable_like_lax_top_k():
    x = np.array([1, 3, 3, 2, 3], np.float32)
    _, idx = topk_stable(torch.from_numpy(x), 3)
    _, ref_idx = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(idx.numpy(), [1, 2, 4])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    s = np.array([[0.5, 0.5, 0.5, 0.5, 0.9], [2, 1, 2, 1, 2]], np.float32)
    vals, idx = rank(torch.from_numpy(s), 4)
    ref_vals, ref_idx = ref_core.rank(jnp.asarray(s), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


def test_probe_cells_matches_reference():
    index = ref_index("fp32")
    q = corpus().queries_cls
    ours = ivf.probe_cells(carried(index).centroids, torch.from_numpy(q),
                           nprobe=12)
    ref = ref_ivf.probe_cells(index.centroids, jnp.asarray(q), nprobe=12)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", ["fp32", "fp16", "int8"])
def test_search_matches_reference(quant):
    index = ref_index(quant)
    q = corpus().queries_cls
    s, i = ivf.search(carried(index), q, nprobe=6, k=40)
    rs, ri = ref_ivf.search(index, jnp.asarray(q), 6, 40)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0,
                               atol=SCORE_TOL)


def test_search_two_phase_matches_reference():
    index = ref_index("fp32")
    q = corpus().queries_cls
    approx, final, probe = ivf.search_two_phase(carried(index), q, 10, 50, 3)
    r_approx, r_final, r_probe = ref_ivf.search_two_phase(
        index, jnp.asarray(q), 10, 50, 3)
    np.testing.assert_array_equal(probe.numpy(), np.asarray(r_probe))
    for (s, i), (rs, ri) in ((approx, r_approx), (final, r_final)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0,
                                   atol=SCORE_TOL)


def test_chunked_scan_merge_matches_reference():
    """Probes streamed in chunks through the running top-k merge."""
    index = ref_index("fp32")
    ours = carried(index)
    q = corpus().queries_cls
    probe = np.array(ref_ivf.probe_cells(index.centroids, jnp.asarray(q),
                                         nprobe=11))
    s, i = ivf.scan_cells(ours.cell_ids, ours.cell_vecs, ours.cell_scale,
                          torch.from_numpy(q), torch.from_numpy(probe), k=30,
                          probe_chunk=3)
    rs, ri = ref_ivf.scan_cells(index.cell_ids, index.cell_vecs,
                                index.cell_scale, jnp.asarray(q),
                                jnp.asarray(probe), k=30, probe_chunk=3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0,
                               atol=SCORE_TOL)


def test_candidate_filters_and_cost_model_match_reference():
    ids = np.array([[4, -1, 7, 2, -1], [-1, -1, 3, 0, 1]])
    scores = np.arange(10, dtype=np.float32).reshape(2, 5)
    alive = np.array([True, False, True, True, True, True, True, False])
    for b in range(2):
        for a, r in zip(ivf.valid_candidates(ids[b], scores[b]),
                        ref_ivf.valid_candidates(ids[b], scores[b])):
            np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(ivf.mask_dead(ids, alive),
                                  ref_ivf.mask_dead(ids, alive))
    assert ivf.mask_dead(ids, None) is ids
    index = ref_index("fp32")
    ours = carried(index)
    cost, ref_cost = ivf.ANNCostModel(), ref_ivf.ANNCostModel()
    assert cost.time(ours, 12) == ref_cost.time(index, 12)
    assert cost.prefetch_budget(ours, 12, 3) == \
        ref_cost.prefetch_budget(index, 12, 3)


def _assignment(index) -> np.ndarray:
    ids = np.asarray(index.cell_ids)
    cell = np.full(index.n_docs, -1)
    for c in range(ids.shape[0]):
        row = ids[c][ids[c] >= 0]
        cell[row] = c
    return cell


def _recall(index, search_fn, k=10, nprobe=4):
    c = corpus()
    exact = np.argsort(-(c.queries_cls @ c.cls.T), axis=1,
                       kind="stable")[:, :k]
    _, got = search_fn(index, c.queries_cls, nprobe, k)
    got = np.asarray(got)
    return np.mean([len(set(e) & set(g)) / k for e, g in zip(exact, got)])


def test_build_ivf_agrees_with_reference():
    c = corpus()
    ref = ref_index("fp32")
    ours = ivf.build_ivf(c.cls, ncells=32, iters=4, device="cpu")
    assert ours.cell_ids.shape == tuple(ref.cell_ids.shape)
    np.testing.assert_allclose(ours.centroids.numpy(),
                               np.asarray(ref.centroids), atol=1e-4)
    agree = float(np.mean(_assignment(ours) == _assignment(ref)))
    assert agree >= 0.99, agree
    r_ours = _recall(ours, lambda i, q, p, k: ivf.search(i, q, p, k))
    r_ref = _recall(ref, lambda i, q, p, k: ref_ivf.search(
        i, jnp.asarray(q), p, k))
    assert r_ours == r_ref
