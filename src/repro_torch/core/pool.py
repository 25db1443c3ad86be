"""Deterministic token pooling to a fixed k vectors per document.

Constant-space multi-vector retrieval (MacAvaney et al. 2025) replaces each
document's ragged (t_i, d) token matrix with exactly k pooled vectors, so the
disk layout becomes fixed-stride (see ``storage/layout.py``, mode
``fixed_stride``): every row costs the same number of blocks, offsets are
computable instead of stored, and batch-plan arithmetic collapses to
multiply-and-slice.

Pooling must stay MaxSim-compatible: a query scores a pooled doc with the
same Chamfer/MaxSim operator as a ragged one. Two properties make the
fixed-k padding safe:

- for t_i <= k the original tokens are kept verbatim and the remaining rows
  are filled with the token mean; ``mean . q`` is the average of the token
  dot products, which can never exceed their max, so MaxSim is unchanged
  (and pooling is idempotent at t_i == k);
- for t_i > k a seeded k-means over the doc's tokens produces k cluster
  means, the standard constant-space compression.

Everything here is deterministic in (content, k, seed) only — no global
state, no per-doc-index seeding — so a doc pools to the same vectors
whenever and wherever it is pooled, and the corpus may be pooled in
parallel pieces.
"""
from __future__ import annotations

import numpy as np


def pool_tokens(tokens: np.ndarray, k: int, *, seed: int = 0,
                iters: int = 8) -> np.ndarray:
    """Pool one doc's (t, d) token matrix to exactly (k, d) float32 rows."""
    if k <= 0:
        raise ValueError(f"pool k must be positive, got {k}")
    tokens = np.asarray(tokens, np.float32)
    t, d = tokens.shape
    if t == 0:
        return np.zeros((k, d), np.float32)
    if t <= k:
        out = np.empty((k, d), np.float32)
        out[:t] = tokens
        if t < k:
            out[t:] = tokens.mean(axis=0)
        return out
    return _kmeans_pool(tokens, k, seed=seed, iters=iters)


def _kmeans_pool(tokens: np.ndarray, k: int, *, seed: int,
                 iters: int) -> np.ndarray:
    """Seeded Lloyd iterations; centroid order is fixed by the (sorted)
    init sample so the result is a pure function of (content, k, seed)."""
    t, d = tokens.shape
    rng = np.random.default_rng(seed)
    init = np.sort(rng.choice(t, size=k, replace=False))
    cent = tokens[init].copy()
    assign = None
    for _ in range(iters):
        # (t, k) squared distances via the expanded form; argmin ties break
        # toward the lower centroid index (numpy argmin contract)
        d2 = (tokens * tokens).sum(1, keepdims=True) \
            - 2.0 * (tokens @ cent.T) + (cent * cent).sum(1)[None, :]
        new_assign = d2.argmin(1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        sums = np.zeros((k, d), np.float64)
        np.add.at(sums, assign, tokens.astype(np.float64))
        counts = np.bincount(assign, minlength=k)
        live = counts > 0
        cent[live] = (sums[live] / counts[live, None]).astype(np.float32)
        # empty clusters keep their previous centroid (deterministic; they
        # can re-acquire points on the next iteration)
    return cent


def pool_corpus(bow_embs: list[np.ndarray], k: int, *, seed: int = 0,
                iters: int = 8) -> list[np.ndarray]:
    """Pool every doc of a ragged BOW list to (k, d) rows (same seed for
    all docs — determinism is content-based, not position-based)."""
    return [pool_tokens(b, k, seed=seed, iters=iters) for b in bow_embs]
