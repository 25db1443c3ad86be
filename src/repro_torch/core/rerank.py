"""Early re-ranking, partial re-ranking, and score aggregation (paper §4.3-4.4).

Early re-ranking: MaxSim runs on prefetched embeddings during the remaining
ANN probes; the critical path only scores the misses and merges.

Partial re-ranking: only the top R candidates (by candidate-generation score)
get MaxSim; the rest keep their CLS ordering.

The gathered rows are host numpy (the storage tier is a host blob); each
MaxSim call moves the query and its rows to the device and runs the
``kernels/maxsim`` op there.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.maxsim.ops import maxsim


@dataclass
class RerankOutput:
    doc_ids: np.ndarray          # ranked doc ids (k,)
    scores: np.ndarray           # aggregate scores, descending
    n_reranked: int
    bow_bytes_read: int          # bandwidth bill for this query


def _maxsim_np(q_bow: np.ndarray, q_len: int, d_bow: np.ndarray,
               d_lens: np.ndarray, device: torch.device) -> np.ndarray:
    """q_bow (Lq, D); d_bow (K, T, D); returns (K,) fp32 MaxSim scores,
    computed on ``device``."""
    if d_bow.shape[0] == 0:
        return np.zeros((0,), np.float32)
    q = torch.as_tensor(np.ascontiguousarray(q_bow[:q_len], np.float32),
                        device=device)
    docs = torch.as_tensor(np.ascontiguousarray(d_bow, np.float32),
                           device=device)
    lens = torch.as_tensor(np.asarray(d_lens, np.int32), device=device)
    qm = torch.ones(q_len, dtype=torch.float32, device=device)
    return maxsim(q, qm, docs, lens).cpu().numpy()


def rerank_query(q_bow, q_len, result, *, alpha: float = 1.0,
                 rerank_count: int | None = None, doc_bytes=None,
                 select: np.ndarray | None = None,
                 device: torch.device | str = "cpu") -> RerankOutput:
    """Score one QueryResult (from ANNPrefetcher.run_batch).

    rerank_count=None -> exact (re-rank every candidate, hits scored early,
    misses in the critical path). rerank_count=R -> partial re-ranking of the
    top-R candidates by CLS score; remaining docs keep alpha*CLS only.
    select=<positions> -> MaxSim exactly those candidate positions (the
    bit-filter survivors of the bitvec and cascade backends) instead of the
    CLS top-R.
    """
    if result.wait_io is not None:
        # batch I/O engine: block until this query's arena runs have landed
        result.wait_io()
    ids = result.doc_ids
    k = len(ids)
    if select is not None:
        sel = np.asarray(select, np.int64)
        rr = len(sel)
    else:
        rr = k if rerank_count is None else min(rerank_count, k)
        # candidates arrive CLS-sorted (IVF top-k): top-rr get MaxSim
        sel = np.arange(rr)

    bow_scores = np.zeros(k, np.float32)
    bytes_read = 0
    # hits: scored from the prefetch buffers (early re-rank)
    pref_rows, pref_pos = [], []
    miss_rows, miss_pos = [], []
    # batch I/O engine: miss rows point into the shared miss arena directly
    miss_row_of = result.miss_rows if result.miss_rows is not None else {}
    for j in sel:
        i = int(ids[j])
        if i in result.prefetched and result.buffers is not None:
            pref_rows.append(result.prefetched[i])
            pref_pos.append(j)
        elif i in miss_row_of:
            miss_rows.append(miss_row_of[i])
            miss_pos.append(j)
    if pref_rows:
        _, bow, lens = result.buffers
        bow_scores[pref_pos] = _maxsim_np(q_bow, q_len, bow[pref_rows],
                                          lens[pref_rows], device)
    if miss_rows:
        _, bow, lens = result.miss_buffers
        bow_scores[miss_pos] = _maxsim_np(q_bow, q_len, bow[miss_rows],
                                          lens[miss_rows], device)
    if doc_bytes is not None:
        bytes_read = int(sum(doc_bytes(int(ids[j])) for j in sel))

    agg = alpha * result.cand_scores[:k] + bow_scores
    order = np.argsort(-agg, kind="stable")
    return RerankOutput(doc_ids=ids[order], scores=agg[order], n_reranked=rr,
                        bow_bytes_read=bytes_read)
