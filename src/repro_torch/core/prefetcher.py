"""ESPN's ANN-guided software prefetcher (paper §4.2).

After δ of η probes the partial top-K is snapshotted and its documents are
read from the storage tier *while* the remaining λ = η − δ probes run; only
the misses (final∖prefetched) are fetched in the critical path. Equations
(2)–(4) of the paper:

    PrefetchBudget ≅ ANNTime(η) − ANNTime(δ)
    PrefetchStep   = δ/η
    BatchThreshold = BW·Budget / bytes_per_query
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.ivf import (ANNCostModel, IVFIndex, mask_dead,
                                  search_two_phase, valid_candidates)
from repro_torch.storage.batch_io import DeviceArena
from repro_torch.storage.io_engine import StorageTier


@dataclass
class PrefetchStats:
    hit_rate: float
    n_prefetched: int
    n_hits: int
    n_misses: int
    budget_s: float
    prefetch_io_s: float
    leaked_s: float               # prefetch time exceeding the budget
    miss_io_s: float
    ann_s: float


@dataclass
class QueryResult:
    doc_ids: np.ndarray           # final candidate ids (k,)
    cand_scores: np.ndarray       # candidate-generation (CLS) scores
    hit_mask: np.ndarray          # True where the doc was prefetched
    stats: PrefetchStats
    prefetched: dict = field(default_factory=dict)   # id -> row in buffers
    buffers: DeviceArena | None = None   # device arena of prefetched docs
    miss_buffers: DeviceArena | None = None
    miss_rows: dict | None = None  # id -> row in miss_buffers (batch arena);
                                   # None = positional (one read of the
                                   # misses in candidate order)
    wait_io: object | None = None  # callable: block until this query's async
                                   # batch-I/O runs landed (rerank calls it)
    io_failed: bool = False        # a storage read this query depends on
                                   # failed: it has no rows; answer
                                   # degraded from candidate scores, never
                                   # score it

    @classmethod
    def from_read(cls, doc_ids: np.ndarray, cand_scores: np.ndarray, read,
                  *, ann_s: float) -> "QueryResult":
        """Result for a non-prefetching stack: every fetched document came
        through the critical path, so the hit mask is empty and the read's
        arena (rows in the order of the ids read, which may be the top-R
        candidates alone) holds the misses. ``n_misses`` counts the rows
        actually read, not every candidate."""
        stats = PrefetchStats(hit_rate=0.0, n_prefetched=0, n_hits=0,
                              n_misses=len(read.arena.lens), budget_s=0.0,
                              prefetch_io_s=0.0, leaked_s=0.0,
                              miss_io_s=read.sim_seconds, ann_s=ann_s)
        return cls(doc_ids=doc_ids, cand_scores=cand_scores,
                   hit_mask=np.zeros(len(doc_ids), bool), stats=stats,
                   miss_buffers=read.arena)

    @classmethod
    def from_batch_view(cls, doc_ids: np.ndarray, cand_scores: np.ndarray,
                        batch, b: int, *, ann_s: float) -> "QueryResult":
        """Result whose buffers are query ``b``'s view of a
        ``BatchReadResult``: the shared device arena plus an id->row map.
        I/O is billed in the critical path with the query's first-owner
        attribution share; ``wait_io`` defers the arrival barrier to the
        re-rank, so reads of later queries overlap this query's scoring.
        """
        buffers, row_map, io_s = batch.view(b)
        stats = PrefetchStats(hit_rate=0.0, n_prefetched=0, n_hits=0,
                              n_misses=len(batch.plan.lists[b]), budget_s=0.0,
                              prefetch_io_s=0.0, leaked_s=0.0,
                              miss_io_s=io_s, ann_s=ann_s)
        return cls(doc_ids=doc_ids, cand_scores=cand_scores,
                   hit_mask=np.zeros(len(doc_ids), bool), stats=stats,
                   prefetched=row_map, buffers=buffers,
                   wait_io=(lambda: batch.ensure_query(b)),
                   io_failed=batch.query_failed(b))


class ANNPrefetcher:
    """Two-phase IVF search + overlapped storage prefetch."""

    def __init__(self, index: IVFIndex, tier: StorageTier, *,
                 prefetch_step: float = 0.10,
                 cost_model: ANNCostModel | None = None, tracer=None):
        self.index = index
        self.tier = tier
        self.prefetch_step = prefetch_step
        self.cost = cost_model or ANNCostModel()
        self.tracer = tracer          # repro_torch.obs.Tracer | None (off)

    def delta(self, nprobe: int) -> int:
        return max(1, int(round(self.prefetch_step * nprobe)))

    def run_batch(self, q: np.ndarray, *, nprobe: int, k: int,
                  fetch: bool = True) -> list[QueryResult]:
        """q: (B, d). Returns one QueryResult per query.

        The IVF compute is batched (on the index's device) and so is the
        I/O: all queries' prefetch lists go to the storage tier as ONE
        coalesced ``read_batch``, and the misses as a second. In coalesced
        mode a miss that any query already prefetched is served from the
        shared prefetch arena instead of re-read. The accounting stays
        per-query via first-owner attribution shares, which sum exactly to
        the batch totals. Tombstoned docs (a mutable tier's ``alive``) are
        dropped before the lists form. ``fetch=False`` plans the lists and
        stats but reads nothing (no buffers, no I/O bill).

        With a tracer, the host work is timed in ``cat="host"`` spans:
        ``ivf_search`` (the search and its copy to the host), ``hit_masks``,
        ``reuse_check`` and ``views`` (the per-query results).
        """
        tr = self.tracer
        delta = self.delta(nprobe)
        sp = tr.begin("ivf_search", cat="host") if tr is not None else None
        approx, final, _ = search_two_phase(self.index, q, nprobe, k, delta)
        a_ids = approx[1].cpu().numpy()
        f_scores, f_ids = (t.cpu().numpy() for t in final)
        if tr is not None:
            tr.end(sp)
        # tombstones: deleted docs become -1 padding BEFORE the prefetch and
        # miss lists form, so they are never fetched, never scored, and never
        # inserted into any cache
        alive = getattr(self.tier, "alive", None)
        a_ids = mask_dead(a_ids, alive)
        f_ids = mask_dead(f_ids, alive)

        budget = self.cost.prefetch_budget(self.index, nprobe, delta)
        ann_total = self.cost.time(self.index, nprobe)

        B = q.shape[0]
        pref_lists, fins, hit_masks, miss_lists = [], [], [], []
        if tr is not None:
            sp = tr.begin("hit_masks", cat="host")
        for b in range(B):
            pref_ids = a_ids[b][a_ids[b] >= 0]
            fin_ids, fin_scores = valid_candidates(f_ids[b], f_scores[b])
            hit_mask = np.isin(fin_ids, pref_ids, assume_unique=False)
            pref_lists.append(pref_ids)
            fins.append((fin_ids, fin_scores))
            hit_masks.append(hit_mask)
            miss_lists.append(fin_ids[~hit_mask])
        if tr is not None:
            tr.end(sp, n_candidates=sum(len(f) for f, _ in fins),
                   n_hits=int(sum(int(m.sum()) for m in hit_masks)))

        pref_batch = miss_batch = None
        fetch_lists = miss_lists
        served_masks = None
        if fetch:
            pref_batch = self.tier.read_batch(pref_lists, skip_empty=True)
            if pref_batch.coalesced:
                # cross-query reuse: misses already in the batch's prefetch
                # arena are served from memory, not re-read from storage
                if tr is not None:
                    sp = tr.begin("reuse_check", cat="host")
                served_masks = [pref_batch.plan.contains(m)
                                for m in miss_lists]
                fetch_lists = [m[~mask]
                               for m, mask in zip(miss_lists, served_masks)]
                if tr is not None:
                    tr.end(sp, n_misses=sum(len(m) for m in miss_lists),
                           n_served=int(sum(int(m.sum())
                                            for m in served_masks)))
            miss_batch = self.tier.read_batch(fetch_lists, skip_empty=True)

        if tr is not None:
            sp = tr.begin("views", cat="host", n_queries=B)
        results = []
        for b in range(B):
            fin_ids, fin_scores = fins[b]
            hit_mask = hit_masks[b]
            buffers, pref_rows, pref_io = (None, {}, 0.0) if not fetch \
                else pref_batch.view(b)
            miss_buffers, miss_rows, miss_io = (None, None, 0.0) \
                if not fetch else miss_batch.view(b)
            wait_io = None
            if fetch and pref_batch.coalesced:
                served_rows = np.empty(0, np.int64)
                served = miss_lists[b][served_masks[b]] if served_masks \
                    else miss_lists[b][:0]
                if len(served):
                    served_rows = pref_batch.plan.rows_of(served)
                    pref_rows = dict(pref_rows)
                    pref_rows.update(zip(served.tolist(),
                                         served_rows.tolist()))
                # barrier covers this query's own runs AND the prefetch-arena
                # runs it borrows served misses from (owned by other queries)
                wait_io = (lambda b=b, rows=served_rows: (
                    pref_batch.ensure_query(b),
                    pref_batch.ensure_rows(rows),
                    miss_batch.ensure_query(b)))
            stats = PrefetchStats(
                hit_rate=float(hit_mask.mean()) if len(fin_ids) else 1.0,
                n_prefetched=len(pref_lists[b]),
                n_hits=int(hit_mask.sum()),
                n_misses=len(miss_lists[b]),
                budget_s=budget,
                prefetch_io_s=pref_io,
                leaked_s=max(0.0, pref_io - budget),
                miss_io_s=miss_io,
                ann_s=ann_total,
            )
            io_failed = False
            if fetch:
                served_rows_b = (pref_batch.plan.rows_of(
                    miss_lists[b][served_masks[b]])
                    if served_masks and served_masks[b].any()
                    else np.empty(0, np.int64))
                io_failed = (pref_batch.query_failed(b)
                             or miss_batch.query_failed(b)
                             or pref_batch.rows_failed(served_rows_b))
            results.append(QueryResult(
                doc_ids=fin_ids, cand_scores=fin_scores,
                hit_mask=hit_mask, stats=stats, prefetched=pref_rows,
                buffers=buffers, miss_buffers=miss_buffers,
                miss_rows=miss_rows, wait_io=wait_io,
                io_failed=io_failed))
        if tr is not None:
            tr.end(sp)
        return results

    # --- paper eq. (4) -----------------------------------------------------
    def batch_threshold(self, nprobe: int, bytes_per_query: float) -> float:
        budget = self.cost.prefetch_budget(self.index, nprobe,
                                           self.delta(nprobe))
        return self.tier.spec.seq_bw * budget / max(bytes_per_query, 1.0)
