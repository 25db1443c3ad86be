"""Early re-ranking, partial re-ranking, and score aggregation (paper §4.3-4.4).

Early re-ranking: MaxSim runs on prefetched embeddings during the remaining
ANN probes; the critical path only scores the misses and merges.

Partial re-ranking: only the top R candidates (by candidate-generation score)
get MaxSim; the rest keep their CLS ordering.

The storage tier hands each query a ``DeviceArena``: the batch's raw
stored-dtype token rows already on the device. Each MaxSim call builds its
docs' row-index table there, packs the padded (K, t_max, D) tiles with
``kernels/gather_pack`` (the paper's §5.1 restructuring kernel) and scores
them with ``kernels/maxsim``; only the query goes to the device and only
the scores come back.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.gather_pack.ops import gather_pack
from repro_torch.kernels.maxsim.ops import maxsim
from repro_torch.storage.batch_io import DeviceArena
from repro_torch.storage.faults import DegradedQueryError


@dataclass
class RerankOutput:
    doc_ids: np.ndarray          # ranked doc ids (k,)
    scores: np.ndarray           # aggregate scores, descending
    n_reranked: int
    bow_bytes_read: int          # bandwidth bill for this query
    degraded: bool = False       # answered from candidate scores because
                                 # the SSD rerank read failed


def pack_tiles(arena: DeviceArena, rows) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The padded (K, t_max, D) doc tiles of the arena ``rows`` and their
    (K,) int32 token counts, on the arena's device.

    Row k of the (K, t_max) int32 index table is ``first[rows[k]] + t`` for
    ``t < lens[rows[k]]`` and -1 (pad) after; ``gather_pack`` packs the
    tiles in the stored dtype. fp16 and fp32 tiles stay as they are
    (``maxsim`` widens fp16 itself); other dtypes, and any layout with
    per-doc scales, are widened to fp32 and scaled after the pack, as the
    reference's ``unpack_doc`` does."""
    dev = arena.pool.device
    r = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    lens = arena.lens[r]
    steps = torch.arange(arena.t_max, device=dev)
    idx = torch.where(steps[None, :] < lens[:, None],
                      arena.first[r][:, None] + steps[None, :],
                      -1).to(torch.int32)
    tiles = gather_pack(arena.pool, idx)
    if arena.scales is not None:
        tiles = tiles.float() * arena.scales[r][:, None, None]
    elif tiles.dtype not in (torch.float16, torch.float32):
        tiles = tiles.float()
    return tiles, lens


def _maxsim_np(q_bow: np.ndarray, q_len: int, arena: DeviceArena,
               rows) -> np.ndarray:
    """MaxSim scores (K,) fp32 of the arena ``rows`` against
    ``q_bow[:q_len]``, computed on the arena's device."""
    if len(rows) == 0:
        return np.zeros((0,), np.float32)
    tiles, lens = pack_tiles(arena, rows)
    dev = tiles.device
    q = torch.as_tensor(np.ascontiguousarray(q_bow[:q_len], np.float32),
                        device=dev)
    qm = torch.ones(q_len, dtype=torch.float32, device=dev)
    return maxsim(q, qm, tiles, lens).cpu().numpy()


def degraded_rerank(result, *, alpha: float = 1.0,
                    select: np.ndarray | None = None,
                    degrade: bool = True) -> RerankOutput:
    """Answer a query whose SSD rerank read failed, without touching its
    rows (it has none): candidates keep their candidate-stage ordering
    (alpha*CLS / FDE score); bit-filter survivors (``select``) rank first in
    bit-score order, the best resident signal there is. No MaxSim runs.
    ``degrade=False`` raises instead (failed reads fail hard)."""
    if not degrade:
        raise DegradedQueryError(
            "storage read failed and degraded-mode answering is disabled "
            "(FaultConfig.degrade=False)")
    ids = result.doc_ids
    k = len(ids)
    agg = alpha * np.asarray(result.cand_scores[:k], np.float32)
    if select is not None and len(select):
        sel = np.asarray(select, np.int64)
        rest = np.setdiff1d(np.arange(k), sel)   # candidate order preserved
        order = np.concatenate([sel, rest])
    else:
        order = np.argsort(-agg, kind="stable")
    return RerankOutput(doc_ids=ids[order], scores=agg[order], n_reranked=0,
                        bow_bytes_read=0, degraded=True)


def rerank_query(q_bow, q_len, result, *, alpha: float = 1.0,
                 rerank_count: int | None = None, doc_bytes=None,
                 select: np.ndarray | None = None,
                 degrade: bool = True, tracer=None) -> RerankOutput:
    """Score one QueryResult (from ANNPrefetcher.run_batch).

    rerank_count=None -> exact (re-rank every candidate, hits scored early,
    misses in the critical path). rerank_count=R -> partial re-ranking of the
    top-R candidates by CLS score; remaining docs keep alpha*CLS only.
    select=<positions> -> MaxSim exactly those candidate positions (the
    bit-filter survivors of the bitvec and cascade backends) instead of the
    CLS top-R.

    A query whose storage read failed (``result.io_failed``) launches no
    kernel: it is answered from candidate-stage scores with
    ``degraded=True`` (or raises ``DegradedQueryError`` when
    ``degrade=False``).

    With a ``tracer``, the host work is timed in ``cat="host"`` spans:
    ``bill`` (the byte bill), ``lookup`` (each selected candidate's arena
    row) and ``score`` (the tiles, MaxSim, the copies back and the ranking);
    the wait for the rows times itself (``io_wait``).
    """
    if result.io_failed:
        return degraded_rerank(result, alpha=alpha, select=select,
                               degrade=degrade)
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

    bytes_read = 0
    if doc_bytes is not None:
        sp = tracer.begin("bill", cat="host") if tracer is not None else None
        bytes_read = int(sum(doc_bytes(int(ids[j])) for j in sel))
        if tracer is not None:
            tracer.end(sp)

    if tracer is not None:
        sp = tracer.begin("lookup", cat="host", n_docs=len(sel))
    bow_scores = np.zeros(k, np.float32)
    # hits: scored from the prefetch buffers (early re-rank)
    pref_rows, pref_pos = [], []
    miss_rows, miss_pos = [], []
    miss_row_of = {}
    if result.miss_rows is not None:
        # batch I/O engine: rows point into the shared miss arena directly
        miss_row_of = result.miss_rows
    elif result.miss_buffers is not None:
        # one read of the misses, row j = the j-th missed candidate
        miss_ids = ids[~result.hit_mask]
        miss_row_of = {int(i): j for j, i in enumerate(miss_ids)}
    for j in sel:
        i = int(ids[j])
        if i in result.prefetched and result.buffers is not None:
            pref_rows.append(result.prefetched[i])
            pref_pos.append(j)
        elif i in miss_row_of:
            miss_rows.append(miss_row_of[i])
            miss_pos.append(j)
    if tracer is not None:
        tracer.end(sp)
        sp = tracer.begin("score", cat="host",
                          n_docs=len(pref_rows) + len(miss_rows))
    if pref_rows:
        bow_scores[pref_pos] = _maxsim_np(q_bow, q_len, result.buffers,
                                          pref_rows)
    if miss_rows:
        bow_scores[miss_pos] = _maxsim_np(q_bow, q_len, result.miss_buffers,
                                          miss_rows)

    agg = alpha * result.cand_scores[:k] + bow_scores
    order = np.argsort(-agg, kind="stable")
    out = RerankOutput(doc_ids=ids[order], scores=agg[order], n_reranked=rr,
                       bow_bytes_read=bytes_read)
    if tracer is not None:
        tracer.end(sp)
    return out
