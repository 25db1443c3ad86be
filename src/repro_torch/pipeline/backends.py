"""Retrieval backends behind a string-keyed registry.

The paper's retrieval stacks (Tables 4/5) as ``RetrievalBackend`` classes:
ESPN's prefetched GDS path (``espn``), plain GDS (``gds``), the mmap/swap
O/S baselines, and the all-in-DRAM upper bound. A backend owns the full
query path: candidate generation, storage reads, re-ranking, and the
per-stage latency accounting on the simulated device clock. All backends
return the same ``RetrievalResponse``.
"""
from __future__ import annotations

import abc
from typing import ClassVar

import numpy as np

from repro_torch.core.espn import (ComputeModel, ESPNConfig, LatencyBreakdown,
                                   RetrievalResponse)
from repro_torch.core.ivf import (ANNCostModel, IVFIndex, search,
                                  valid_candidates)
from repro_torch.core.prefetcher import ANNPrefetcher, QueryResult
from repro_torch.core.rerank import RerankOutput, rerank_query
from repro_torch.storage.batch_io import consumption_dedup_saved
from repro_torch.storage.io_engine import StorageTier

_REGISTRY: dict[str, type["RetrievalBackend"]] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("espn")``."""
    def deco(cls: type["RetrievalBackend"]) -> type["RetrievalBackend"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_backend(name: str) -> type["RetrievalBackend"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown retrieval backend {name!r}; registered backends: "
            f"{', '.join(available_backends())}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


class RetrievalBackend(abc.ABC):
    """One retrieval stack: ANN candidate gen -> storage reads -> re-rank.

      storage_stack       the ``StorageTier`` software stack to run on
      needs_mem_budget    True for the O/S paths that operate under a page
                          cache budget (mmap / swap)
    """

    name: ClassVar[str] = ""
    storage_stack: ClassVar[str] = "espn"
    needs_mem_budget: ClassVar[bool] = False

    def __init__(self, index: IVFIndex, tier: StorageTier, cfg: ESPNConfig,
                 *, cost_model: ANNCostModel | None = None,
                 compute: ComputeModel | None = None, doc_bytes=None):
        self.index = index
        self.tier = tier
        self.cfg = cfg
        self.cost = cost_model or ANNCostModel()
        self.compute = compute or ComputeModel()
        self.doc_bytes = doc_bytes or (lambda i: tier.layout.doc_bytes(i))

    # ------------------------------------------------------------------
    def query_batch(self, q_cls: np.ndarray, q_bow: np.ndarray,
                    q_lens: np.ndarray) -> RetrievalResponse:
        bd = LatencyBreakdown()
        bd.encode_s = self.compute.encode_time(q_cls.shape[0])
        ranked = self._retrieve(q_cls, q_bow, q_lens, bd)
        bd.total_s = (bd.encode_s + bd.ann_s + bd.critical_io_s + bd.rerank_s
                      + 0.2e-3)
        return RetrievalResponse(ranked=ranked, breakdown=bd)

    @abc.abstractmethod
    def _retrieve(self, q_cls, q_bow, q_lens,
                  bd: LatencyBreakdown) -> list[RerankOutput]:
        """Fill ``bd``'s ann/hidden/critical/rerank terms; return rankings."""

    # -- shared helpers -----------------------------------------------
    def _maxsim_time(self, n_docs: int, q_len: int) -> float:
        layout = self.tier.layout
        return self.compute.maxsim_time(n_docs, q_len,
                                        float(layout.n_tokens.mean()),
                                        layout.d_bow)

    def _rerank_candidates(self, q_bow, q_lens, scores, ids,
                           bd: LatencyBreakdown) -> list[RerankOutput]:
        """Shared tail of the single-phase candidate generators: per query,
        drop ``-1`` padding keeping ids/scores paired, then read the whole
        batch's top-``rerank_count`` candidates as ONE coalesced
        ``read_batch`` and re-rank each query as its arena rows land. The
        batch pays one coalesced read in the critical path; duplicate
        candidate bytes are billed once (``bd.dedup_bytes_saved``)."""
        cfg = self.cfg
        prep = []
        for b in range(len(ids)):
            fin, fin_scores = valid_candidates(ids[b], scores[b])
            rr = len(fin) if cfg.rerank_count is None else min(
                cfg.rerank_count, len(fin))
            prep.append((fin, fin_scores, rr))
        batch = self.tier.read_batch([fin[:rr] for fin, _, rr in prep])
        bd.critical_io_s += batch.sim_seconds
        ranked = []
        for b, (fin, fin_scores, rr) in enumerate(prep):
            res = QueryResult.from_batch_view(fin, fin_scores, batch, b,
                                              ann_s=bd.ann_s)
            out = rerank_query(q_bow[b], int(q_lens[b]), res,
                               alpha=cfg.alpha, rerank_count=rr,
                               doc_bytes=self.doc_bytes,
                               device=self.index.device)
            ranked.append(out)
            bd.rerank_s += self._maxsim_time(rr, int(q_lens[b]))
            bd.bytes_read += out.bow_bytes_read
        saved = batch.dedup_bytes_saved(self.doc_bytes)
        bd.bytes_read -= saved
        bd.dedup_bytes_saved += saved
        bd.hit_rate = 0.0
        return ranked


@register_backend("espn")
class ESPNBackend(RetrievalBackend):
    """GDS-analogue batched reads + ANN-guided prefetcher + early re-rank
    (the paper's contribution, §4.2-4.3)."""

    storage_stack = "espn"

    def __init__(self, index, tier, cfg, **kw):
        super().__init__(index, tier, cfg, **kw)
        self.prefetcher = ANNPrefetcher(index, tier,
                                        prefetch_step=cfg.prefetch_step,
                                        cost_model=self.cost)

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        cfg = self.cfg
        if q_cls.shape[0] == 0:           # empty batch: nothing to rank,
            return []                     # hit_rate keeps its vacuous default
        results = self.prefetcher.run_batch(q_cls, nprobe=cfg.nprobe,
                                            k=cfg.k_candidates)
        bd.ann_s = results[0].stats.ann_s
        ranked, hit_rates, hidden, critical = [], [], 0.0, 0.0
        for b, res in enumerate(results):
            out = rerank_query(q_bow[b], int(q_lens[b]), res,
                               alpha=cfg.alpha, rerank_count=cfg.rerank_count,
                               doc_bytes=self.doc_bytes,
                               device=self.index.device)
            ranked.append(out)
            early_t = self._maxsim_time(res.stats.n_hits, int(q_lens[b]))
            miss_t = self._maxsim_time(res.stats.n_misses, int(q_lens[b]))
            hidden_work = res.stats.prefetch_io_s + early_t
            leaked = max(0.0, hidden_work - res.stats.budget_s)
            hidden += min(hidden_work, res.stats.budget_s)
            critical += leaked + res.stats.miss_io_s
            bd.rerank_s += miss_t
            hit_rates.append(res.stats.hit_rate)
            bd.bytes_read += out.bow_bytes_read
        bd.hidden_s = hidden
        bd.critical_io_s = critical
        bd.hit_rate = float(np.mean(hit_rates))
        if self.tier.coalesce:
            # batch engine billed each doc once; surface the duplicate
            # consumptions the serial path would have re-billed
            saved = consumption_dedup_saved(
                [res.doc_ids[:out.n_reranked]
                 for res, out in zip(results, ranked)], self.doc_bytes)
            bd.bytes_read -= saved
            bd.dedup_bytes_saved += saved
        return ranked


class DirectBackend(RetrievalBackend):
    """Shared path for the non-prefetching stacks: single-phase ANN, then
    every candidate read sits in the critical path. Subclasses only choose
    the storage stack (which sets the simulated clock in io_engine)."""

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        cfg = self.cfg
        if q_cls.shape[0] == 0:
            bd.hit_rate = 0.0
            return []
        scores, ids = search(self.index, q_cls, cfg.nprobe, cfg.k_candidates)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        bd.ann_s = self.cost.time(self.index, cfg.nprobe)
        return self._rerank_candidates(q_bow, q_lens, scores, ids, bd)


@register_backend("gds")
class GDSBackend(DirectBackend):
    """GDS-analogue batched reads, no prefetch: the paper's ablation where
    all storage I/O lands in the critical path."""
    storage_stack = "espn"


@register_backend("mmap")
class MmapBackend(DirectBackend):
    """Conventional mmap'd index under a page-cache memory budget."""
    storage_stack = "mmap"
    needs_mem_budget = True


@register_backend("swap")
class SwapBackend(DirectBackend):
    """Anonymous memory + kernel swap under a memory budget."""
    storage_stack = "swap"
    needs_mem_budget = True


@register_backend("dram")
class DRAMBackend(DirectBackend):
    """Whole index resident in memory: the paper's upper-bound baseline."""
    storage_stack = "dram"
