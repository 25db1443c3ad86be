"""Synthetic retrieval corpus with realistic IVF/prefetch behaviour.

MS-MARCO is unavailable offline, so a clustered corpus is generated whose
*curve shapes* (recall vs nprobe, hit rate vs prefetch step, MRR vs rerank
count) match the paper's: CLS vectors on a low-dimensional manifold on the
unit sphere, Zipf-ish document lengths (the paper's 2-10KB BOW blobs), token
vectors correlated with the doc's topic, and queries perturbed from target
documents (qrels = target). The same seed gives the same corpus as the
reference package, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Corpus:
    cls: np.ndarray               # (N, d_cls) unit-norm fp32
    bow: list[np.ndarray]         # N ragged (t_i, d_bow) unit-norm fp32
    doc_lens: np.ndarray          # (N,) int32
    queries_cls: np.ndarray       # (Q, d_cls)
    queries_bow: np.ndarray       # (Q, Lq, d_bow)
    query_lens: np.ndarray        # (Q,) int32
    qrels: list[set]              # relevant doc ids per query

    @property
    def n_docs(self) -> int:
        return len(self.cls)

    @property
    def mean_tokens(self) -> float:
        return float(self.doc_lens.mean())


def _unit(x, axis=-1):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-9)


def make_corpus(n_docs: int = 20_000, n_queries: int = 64, *,
                d_cls: int = 128, d_bow: int = 32, n_clusters: int = 256,
                mean_len: int = 60, max_len: int = 180, q_len: int = 24,
                n_terms: int = 8192, topical_frac: float = 0.5,
                d_latent: int = 8, manifold_noise: float = 0.05,
                query_noise: float = 0.30, with_bow: bool = True,
                query_token_noise: float = 0.08, seed: int = 0) -> Corpus:
    """CLS vectors live on a smooth ``d_latent``-dim manifold embedded in
    ``d_cls`` dims (real text embeddings have low intrinsic dimension), so
    nearest neighbors concentrate in the closest IVF cells — the property
    ESPN's prefetcher exploits. Topics for the term model come from latent
    anchors."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d_latent, d_cls)).astype(np.float32) / np.sqrt(d_latent)
    z = rng.standard_normal((n_docs, d_latent)).astype(np.float32)
    cls = _unit(z @ W + manifold_noise
                * rng.standard_normal((n_docs, d_cls)).astype(np.float32))
    anchors = rng.standard_normal((n_clusters, d_latent)).astype(np.float32)
    assign = np.argmax(z @ anchors.T, axis=-1)

    # Zipf-ish lengths in [8, max_len] with the paper's 2-10KB spread
    lens = np.clip((rng.pareto(2.5, n_docs) + 1) * (mean_len * 0.6), 8,
                   max_len).astype(np.int32)

    # Term-matching token model: a global term vocabulary; each doc mixes
    # cluster-topical terms (shared within a cluster) with doc-specific terms.
    # This gives MaxSim the sharp exact-match signal late interaction exploits
    # on real text (near-1 dots for matched terms).
    terms = _unit(rng.standard_normal((n_terms, d_bow)).astype(np.float32))
    topic_pool = rng.integers(0, n_terms, (n_clusters, 64))
    bow = []
    doc_terms = []
    if with_bow:
        for i in range(n_docs):
            t = int(lens[i])
            n_topic = int(t * topical_frac)
            topical = topic_pool[assign[i], rng.integers(0, 64, n_topic)]
            specific = rng.integers(0, n_terms, t - n_topic)
            tids = np.concatenate([topical, specific])
            rng.shuffle(tids)
            doc_terms.append(tids)
            bow.append(terms[tids].copy())

    # queries: perturb a target doc in LATENT space (stays on the manifold);
    # tokens are (noisy) copies of the target's terms -> the target scores
    # ~q_len under MaxSim, others partial.
    targets = rng.integers(0, n_docs, n_queries)
    zq = z[targets] + query_noise * rng.standard_normal(
        (n_queries, d_latent)).astype(np.float32)
    q_cls = _unit(zq @ W + manifold_noise
                  * rng.standard_normal((n_queries, d_cls)).astype(np.float32))
    q_bow = np.zeros((n_queries, q_len, d_bow), np.float32)
    q_lens = np.full(n_queries, q_len, np.int32)
    if with_bow:
        for qi, t in enumerate(targets):
            tids = doc_terms[t]
            take = tids[rng.integers(0, len(tids), q_len)]
            q_bow[qi] = _unit(terms[take] + query_token_noise
                              * rng.standard_normal((q_len, d_bow)).astype(np.float32))
    qrels = [{int(t)} for t in targets]
    return Corpus(cls=cls, bow=bow, doc_lens=lens, queries_cls=q_cls,
                  queries_bow=q_bow, query_lens=q_lens, qrels=qrels)


def make_lm_batch(rng_seed: int, batch: int, seq: int, vocab: int):
    """Synthetic LM tokens for train examples/smoke tests."""
    rng = np.random.default_rng(rng_seed)
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}
