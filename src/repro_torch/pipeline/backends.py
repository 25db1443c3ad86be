"""Retrieval backends behind a string-keyed registry.

The paper's retrieval stacks (Tables 4/5) as ``RetrievalBackend`` classes:
ESPN's prefetched GDS path (``espn``), plain GDS (``gds``), the mmap/swap
O/S baselines, and the all-in-DRAM upper bound, joined by the related
work's bit-vector rerank (``bitvec``, Nardini et al. 2024), MUVERA-style FDE
candidate generation (``fde``, Dhulipala et al. 2024), the cascade of the
two (``cascade``) and the constant-space SSD rerank over the pooled
``fixed_stride`` layout (``cspn``, MacAvaney et al. 2025). A backend owns the full query path: candidate
generation, storage reads, re-ranking, and the per-stage latency accounting
on the simulated device clock. All backends return the same
``RetrievalResponse``.

A query whose storage read failed (fault injection, ``storage/faults.py``)
is answered in degraded mode from its candidate-stage scores and launches
no MaxSim. With a ``Tracer`` attached (``attach_tracer``), every batch
records the reference's span tree: ``query_batch`` over ``encode``,
``candidate_gen``, ``read`` and the per-query ``bit_filter``,
``hidden_io``/``critical_io``, ``rerank`` (its wall: the ``rerank_query``
call) and ``degrade`` spans; beside them, ``cat="host"`` spans time the
host work (``ivf_search``, ``views``, ``bill`` here; the prefetcher's,
the tier's and ``rerank_query``'s own). With none, no tracing code runs.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar

import numpy as np
import torch

from repro_torch.core.espn import (ComputeModel, ESPNConfig, LatencyBreakdown,
                                   RetrievalResponse)
from repro_torch.core.fde import FDEEncoder
from repro_torch.core.ivf import (ANNCostModel, IVFIndex, build_ivf, ivf_add,
                                  mask_dead, search, valid_candidates)
from repro_torch.core.maxsim import topk_stable
from repro_torch.core.prefetcher import ANNPrefetcher, QueryResult
from repro_torch.core.rerank import RerankOutput, rerank_query
from repro_torch.kernels.bitsim.ops import bitsim
from repro_torch.kernels.fdescan.ops import fdescan
from repro_torch.storage.batch_io import consumption_dedup_saved
from repro_torch.storage.io_engine import StorageTier

_REGISTRY: dict[str, type["RetrievalBackend"]] = {}
#: the tier's fault counters each batch's breakdown carries as deltas
_FAULT_KEYS = ("retries", "checksum_failures", "repair_bytes",
               "faults_injected")


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
      needs_bit_table     True for backends that filter against the resident
                          sign-bit tier (the tier must carry a BitTable)
      needs_fde_table     True for backends that candidate-generate against
                          the resident FDE tier (the tier must carry an
                          FDETable)
    """

    name: ClassVar[str] = ""
    storage_stack: ClassVar[str] = "espn"
    needs_mem_budget: ClassVar[bool] = False
    needs_bit_table: ClassVar[bool] = False
    needs_fde_table: ClassVar[bool] = False

    def __init__(self, index: IVFIndex, tier: StorageTier, cfg: ESPNConfig,
                 *, cost_model: ANNCostModel | None = None,
                 compute: ComputeModel | None = None, doc_bytes=None,
                 tracer=None):
        self.index = index
        self.tier = tier
        self.cfg = cfg
        self.cost = cost_model or ANNCostModel()
        self.compute = compute or ComputeModel()
        self.doc_bytes = doc_bytes or (lambda i: tier.layout.doc_bytes(i))
        self.tracer = tracer          # repro_torch.obs.Tracer | None (off)

    def attach_tracer(self, tracer) -> None:
        """Thread ``tracer`` through this backend and its storage tier (a
        backend with more parts overrides this to reach them too); ``None``
        detaches it."""
        self.tracer = tracer
        self.tier.tracer = tracer

    # ------------------------------------------------------------------
    def query_batch(self, q_cls: np.ndarray, q_bow: np.ndarray,
                    q_lens: np.ndarray) -> RetrievalResponse:
        tr = self.tracer
        root = None
        if tr is not None:
            tr.adopt_batch_qids()
            root = tr.begin("query_batch", cat="batch", mode=self.name,
                            n_queries=int(q_cls.shape[0]))
        bd = LatencyBreakdown()
        bd.encode_s = self.compute.encode_time(q_cls.shape[0])
        if tr is not None:
            tr.add("encode", cat="compute", sim_s=bd.encode_s)
        # hedged re-issues and injected faults happen inside the tier
        # (storage cluster): this batch's share is the delta of the tier's
        # counters
        hedge0 = self.tier.stats.get("hedge_bytes", 0)
        f0 = {k: self.tier.stats.get(k, 0) for k in _FAULT_KEYS}
        try:
            ranked = self._retrieve(q_cls, q_bow, q_lens, bd)
        except BaseException:
            if root is not None and not root.closed:
                tr.end(root, error=True)
            raise
        bd.hedge_bytes_read = self.tier.stats.get("hedge_bytes", 0) - hedge0
        for k in _FAULT_KEYS:
            setattr(bd, k, self.tier.stats.get(k, 0) - f0[k])
        bd.degraded_queries = sum(int(r.degraded) for r in ranked)
        bd.total_s = (bd.encode_s + bd.ann_s + bd.critical_io_s + bd.rerank_s
                      + 0.2e-3)
        if tr is not None:
            tr.end(root, sim_s=bd.total_s, breakdown=bd.as_dict())
        return RetrievalResponse(ranked=ranked, breakdown=bd)

    @abc.abstractmethod
    def _retrieve(self, q_cls, q_bow, q_lens,
                  bd: LatencyBreakdown) -> list[RerankOutput]:
        """Fill ``bd``'s ann/hidden/critical/rerank terms; return rankings."""

    # -- live-mutation hooks ------------------------------------------
    def _dead_masked(self, ids):
        """Tombstone deleted docs out of candidate rows (``-1`` padding;
        ``valid_candidates`` drops them with scores kept paired). Identity
        for tiers without a mutation layer."""
        return mask_dead(ids, getattr(self.tier, "alive", None))

    def on_mutation(self, ingested=None, deleted=None) -> None:
        """Called by ``Pipeline.ingest``/``delete`` after the tier and its
        side tables moved. Deletes need nothing here (the tombstone mask is
        consulted per query); backends holding a copy of a side table
        override this to refresh it on ingest."""

    # -- shared helpers -----------------------------------------------
    def _maxsim_time(self, n_docs: int, q_len: int) -> float:
        tr = self.tracer
        sp = tr.begin("bill", cat="host") if tr is not None else None
        layout = self.tier.layout
        t = self.compute.maxsim_time(n_docs, q_len,
                                     float(layout.n_tokens.mean()),
                                     layout.d_bow)
        if tr is not None:
            tr.end(sp)
        return t

    def _dedup_bill(self, saved_of, *args) -> int:
        """``saved_of(*args, self.doc_bytes)``, the bytes a batch's
        duplicate requests did not move (with a tracer, a ``bill`` span)."""
        tr = self.tracer
        sp = tr.begin("bill", cat="host") if tr is not None else None
        saved = saved_of(*args, self.doc_bytes)
        if tr is not None:
            tr.end(sp)
        return saved

    def _ivf_candidates(self, q_cls, bd: LatencyBreakdown):
        """Single-phase IVF candidate generation: host (scores, ids)."""
        cfg = self.cfg
        tr = self.tracer
        cspan = tr.begin("candidate_gen", cat="compute") \
            if tr is not None else None
        if tr is not None:
            sp = tr.begin("ivf_search", cat="host")
        scores, ids = search(self.index, q_cls, cfg.nprobe, cfg.k_candidates)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
        if tr is not None:
            tr.end(sp)
        bd.ann_s = self.cost.time(self.index, cfg.nprobe)
        if tr is not None:
            tr.end(cspan, sim_s=bd.ann_s)
        return scores, ids

    @staticmethod
    def _trace_query(tr, b: int, io_s: float, out: RerankOutput,
                     maxsim_t: float, wall: tuple[float, float],
                     **io_args) -> None:
        """Query ``b``'s critical-I/O span, then its rerank span (``wall``:
        its ``rerank_query`` call), or a ``degrade`` instant when it was
        answered from candidate scores."""
        qid = tr.query_key(b)
        tr.add("critical_io", cat="io", qid=qid, sim_s=io_s, **io_args)
        if out.degraded:
            tr.instant("degrade", cat="fault", qid=qid)
        else:
            tr.add("rerank", cat="compute", qid=qid, t0=wall[0], t1=wall[1],
                   sim_s=maxsim_t)

    def _rerank_one(self, q_bow, q_len: int, res: QueryResult, **kw):
        """``rerank_query`` of one query and the wall interval of the call
        (``(0.0, 0.0)`` without a tracer)."""
        tr = self.tracer
        t0 = tr.clock() if tr is not None else 0.0
        out = rerank_query(q_bow, q_len, res, alpha=self.cfg.alpha,
                           doc_bytes=self.doc_bytes,
                           degrade=self.tier.degrade_reads, tracer=tr, **kw)
        return out, (t0, tr.clock() if tr is not None else 0.0)

    def _view(self, fin, fin_scores, batch, b: int,
              bd: LatencyBreakdown) -> QueryResult:
        """Query ``b``'s ``QueryResult`` over a coalesced read (with a
        tracer, a ``views`` span)."""
        tr = self.tracer
        sp = tr.begin("views", cat="host", n_queries=1) \
            if tr is not None else None
        res = QueryResult.from_batch_view(fin, fin_scores, batch, b,
                                          ann_s=bd.ann_s)
        if tr is not None:
            tr.end(sp)
        return res

    def _rerank_candidates(self, q_bow, q_lens, scores, ids,
                           bd: LatencyBreakdown) -> list[RerankOutput]:
        """Shared tail of the single-phase candidate generators: per query,
        drop ``-1`` padding keeping ids/scores paired, then read the whole
        batch's top-``rerank_count`` candidates as ONE coalesced
        ``read_batch`` and re-rank each query as its arena rows land. The
        batch pays one coalesced read in the critical path; duplicate
        candidate bytes are billed once (``bd.dedup_bytes_saved``)."""
        cfg = self.cfg
        tr = self.tracer
        ids = self._dead_masked(ids)
        prep = []
        for b in range(len(ids)):
            fin, fin_scores = valid_candidates(ids[b], scores[b])
            rr = len(fin) if cfg.rerank_count is None else min(
                cfg.rerank_count, len(fin))
            prep.append((fin, fin_scores, rr))
        rspan = tr.begin("read", cat="io") if tr is not None else None
        batch = self.tier.read_batch([fin[:rr] for fin, _, rr in prep])
        if tr is not None:
            tr.end(rspan, sim_s=batch.sim_seconds)
        bd.critical_io_s += batch.sim_seconds
        ranked = []
        for b, (fin, fin_scores, rr) in enumerate(prep):
            res = self._view(fin, fin_scores, batch, b, bd)
            out, wall = self._rerank_one(q_bow[b], int(q_lens[b]), res,
                                         rerank_count=rr)
            ranked.append(out)
            maxsim_t = 0.0
            if not out.degraded:       # a degraded query never ran MaxSim
                maxsim_t = self._maxsim_time(rr, int(q_lens[b]))
                bd.rerank_s += maxsim_t
            if tr is not None:
                self._trace_query(tr, b, batch.io_s(b), out, maxsim_t, wall)
            bd.bytes_read += out.bow_bytes_read
        saved = self._dedup_bill(batch.dedup_bytes_saved)
        bd.bytes_read -= saved
        bd.dedup_bytes_saved += saved
        bd.hit_rate = 0.0
        return ranked

    def _bit_filter_rerank(self, q_bow, q_lens, scores, ids,
                           bd: LatencyBreakdown,
                           width: int) -> list[RerankOutput]:
        """Shared bit-filter + SSD-rerank tail (bitvec, cascade): score ALL
        candidates against the resident sign-bit tier with the ``bitsim``
        op on the index's device (zero SSD traffic), keep the top ``width``
        survivors per query, then ONE coalesced ``read_batch`` of the
        survivors and full-precision MaxSim as each query's arena rows land.
        Non-survivors keep their candidate-stage ordering (alpha*CLS for
        bitvec, FDE score for cascade)."""
        tr = self.tracer
        dev = self.index.device
        layout = self.tier.layout
        mean_t = float(layout.n_tokens.mean())
        ids = self._dead_masked(ids)
        # 1) resident bit filter; the survivors are chosen on the host with
        #    the reference's partial sort (argpartition + stable sort of
        #    ``width`` elements), so ties exactly at the cutoff may pick
        #    another equal-score subset than a full stable sort would
        prep = []
        for b in range(len(ids)):
            fin, fin_scores = valid_candidates(ids[b], scores[b])
            qlen = int(q_lens[b])
            packed, lens = self.tier.read_bits(fin)
            q = torch.as_tensor(np.ascontiguousarray(q_bow[b][:qlen],
                                                     np.float32), device=dev)
            bit_s = bitsim(q, torch.ones(qlen, dtype=torch.float32,
                                         device=dev),
                           torch.from_numpy(packed.view(np.int32)).to(dev),
                           torch.from_numpy(lens).to(dev)).cpu().numpy()
            bit_t = self.compute.bitsim_time(len(fin), qlen, mean_t,
                                             layout.d_bow)
            bd.rerank_s += bit_t
            if tr is not None:
                tr.add("bit_filter", cat="compute", qid=tr.query_key(b),
                       sim_s=bit_t, n_candidates=len(fin))
            r = min(width, len(fin))
            if r < len(fin):
                part = np.argpartition(-bit_s, r - 1)[:r]
            else:
                part = np.arange(len(fin))
            sel = part[np.argsort(-bit_s[part], kind="stable")]
            prep.append((fin, fin_scores, sel))
        # 2) ONE coalesced SSD read for every query's survivors, then
        #    full-precision MaxSim per query as its arena rows land
        rspan = tr.begin("read", cat="io") if tr is not None else None
        batch = self.tier.read_batch([fin[sel] for fin, _, sel in prep])
        if tr is not None:
            tr.end(rspan, sim_s=batch.sim_seconds)
        bd.critical_io_s += batch.sim_seconds
        ranked = []
        for b, (fin, fin_scores, sel) in enumerate(prep):
            qlen = int(q_lens[b])
            res = self._view(fin, fin_scores, batch, b, bd)
            out, wall = self._rerank_one(q_bow[b], qlen, res, select=sel)
            ranked.append(out)
            maxsim_t = 0.0
            if not out.degraded:
                maxsim_t = self._maxsim_time(len(sel), qlen)
                bd.rerank_s += maxsim_t
            if tr is not None:
                self._trace_query(tr, b, batch.io_s(b), out, maxsim_t, wall)
            bd.bytes_read += out.bow_bytes_read
        saved = self._dedup_bill(batch.dedup_bytes_saved)
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
                                        cost_model=self.cost,
                                        tracer=self.tracer)

    def attach_tracer(self, tracer) -> None:
        super().attach_tracer(tracer)
        self.prefetcher.tracer = tracer

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        cfg = self.cfg
        tr = self.tracer
        if q_cls.shape[0] == 0:           # empty batch: nothing to rank,
            return []                     # hit_rate keeps its vacuous default
        cspan = tr.begin("candidate_gen", cat="compute") \
            if tr is not None else None
        results = self.prefetcher.run_batch(q_cls, nprobe=cfg.nprobe,
                                            k=cfg.k_candidates)
        bd.ann_s = results[0].stats.ann_s
        if tr is not None:
            tr.end(cspan, sim_s=bd.ann_s)
        ranked, hit_rates, hidden, critical = [], [], 0.0, 0.0
        for b, res in enumerate(results):
            out, wall = self._rerank_one(q_bow[b], int(q_lens[b]), res,
                                         rerank_count=cfg.rerank_count)
            ranked.append(out)
            early_t = self._maxsim_time(res.stats.n_hits, int(q_lens[b]))
            miss_t = self._maxsim_time(res.stats.n_misses, int(q_lens[b]))
            hidden_work = res.stats.prefetch_io_s + early_t
            leaked = max(0.0, hidden_work - res.stats.budget_s)
            hidden += min(hidden_work, res.stats.budget_s)
            critical += leaked + res.stats.miss_io_s
            if not out.degraded:       # a degraded query never ran MaxSim
                bd.rerank_s += miss_t
            if tr is not None:
                tr.add("hidden_io", cat="io", qid=tr.query_key(b),
                       sim_s=min(hidden_work, res.stats.budget_s))
                self._trace_query(tr, b, leaked + res.stats.miss_io_s, out,
                                  miss_t, wall,
                                  hit_rate=round(res.stats.hit_rate, 4))
            hit_rates.append(res.stats.hit_rate)
            bd.bytes_read += out.bow_bytes_read
        bd.hidden_s = hidden
        bd.critical_io_s = critical
        bd.hit_rate = float(np.mean(hit_rates))
        if self.tier.coalesce:
            # batch engine billed each doc once; surface the duplicate
            # consumptions the serial path would have re-billed
            saved = self._dedup_bill(
                consumption_dedup_saved,
                [res.doc_ids[:out.n_reranked]
                 for res, out in zip(results, ranked)])
            bd.bytes_read -= saved
            bd.dedup_bytes_saved += saved
        return ranked


class DirectBackend(RetrievalBackend):
    """Shared path for the non-prefetching stacks: single-phase ANN, then
    every candidate read sits in the critical path. Subclasses only choose
    the storage stack (which sets the simulated clock in io_engine)."""

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        if q_cls.shape[0] == 0:
            bd.hit_rate = 0.0
            return []
        scores, ids = self._ivf_candidates(q_cls, bd)
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


@register_backend("cspn")
class CSPNBackend(DirectBackend):
    """Constant-space SSD rerank: the gds query path run over the
    ``fixed_stride`` pooled layout. Every document holds exactly ``pool_k``
    token vectors at a uniform block stride, so offsets are arithmetic
    (zero resident metadata) and every read moves the same byte count. The
    backend itself is layout-agnostic: on a ragged layout it runs the gds
    path."""
    storage_stack = "espn"


@register_backend("bitvec")
class BitvecBackend(RetrievalBackend):
    """Bit-vector compressed rerank (Nardini et al. 2024): every candidate is
    first scored against the *resident* sign-bit table with a packed-bit
    asymmetric MaxSim (no SSD traffic), then only the top ``bit_filter``
    survivors are read from storage for full-precision MaxSim. Non-survivors
    keep their alpha*CLS ordering."""

    storage_stack = "espn"
    needs_bit_table = True

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        cfg = self.cfg
        if q_cls.shape[0] == 0:
            bd.hit_rate = 0.0
            return []
        scores, ids = self._ivf_candidates(q_cls, bd)
        return self._bit_filter_rerank(q_bow, q_lens, scores, ids, bd,
                                       cfg.bit_filter)


@register_backend("fde")
class FDEBackend(RetrievalBackend):
    """MUVERA-style FDE candidate generation (Dhulipala et al. 2024):
    candidates come from single-vector search over the *resident* fixed
    dimensional encodings of the documents instead of the CLS IVF index;
    only the top candidates are read from storage for full-precision
    MaxSim re-rank.

    Up to ``cfg.fde_brute_threshold`` documents the table is scanned brute
    force (the ``fdescan`` op over a device copy of the table, made once);
    above it an IVF index is built over the doc FDEs and probed like any
    other single-vector index."""

    storage_stack = "espn"
    needs_fde_table = True

    def __init__(self, index, tier, cfg, **kw):
        super().__init__(index, tier, cfg, **kw)
        if tier.fde is None:
            raise RuntimeError(
                "the fde backend needs a StorageTier built with a resident "
                "FDETable; construct it with fde=build_fde_table(...)")
        dev = index.device
        self.encoder = FDEEncoder(tier.fde.cfg, dev)
        n = tier.fde.n_docs
        self.fde_index = None
        self._fde_vecs_dev = None
        if n > cfg.fde_brute_threshold:
            self.fde_index = build_ivf(
                tier.fde.vecs.float().cpu().numpy(),
                ncells=max(16, n // 270), iters=4, device=dev)
        else:
            # one device copy (none when the table was built there), not
            # one per query batch; ingest refreshes it (``on_mutation``)
            self._fde_vecs_dev = tier.fde.vecs.to(dev).contiguous()

    def on_mutation(self, ingested=None, deleted=None) -> None:
        """Ingest grew ``tier.fde`` under this backend: fold the new doc
        FDEs into the IVF over FDEs when one exists, else take the grown
        table as the brute scan's (no copy when it lives on the index's
        device; the appended rows are the rebuild's bits)."""
        if ingested is None or len(ingested) == 0:
            return
        gids = np.asarray(ingested, np.int64)
        vecs = self.tier.fde.vecs
        if self.fde_index is not None:
            ivf_add(self.fde_index,
                    vecs[torch.as_tensor(gids, device=vecs.device)].float(),
                    gids)
        else:
            self._fde_vecs_dev = vecs.to(self.index.device).contiguous()

    def candidate_gen_bytes(self) -> int:
        """Resident bytes this backend's candidate generation needs: the
        FDE table plus its IVF wrapper when one was built. The CLS index
        does not count; this backend never probes it."""
        return self.tier.fde.nbytes + (self.fde_index.memory_bytes()
                                       if self.fde_index is not None else 0)

    def _fde_candidates(self, q_bow, q_lens, bd):
        """Candidate generation against the resident FDE tier: returns host
        (scores, ids) on MaxSim's scale, ready for any rerank tail."""
        cfg = self.cfg
        q_fde = self.encoder.encode_queries(q_bow, q_lens)    # (B, d_fde)
        n = self.tier.fde.n_docs
        if self.fde_index is None:
            scores, ids = topk_stable(fdescan(q_fde, self._fde_vecs_dev),
                                      min(cfg.k_candidates, n))
            # brute scan touches every doc FDE: one flat pass, no centroids
            bd.ann_s = self.cost.t0_s + self.cost.c_cand_s * n
        else:
            scores, ids = search(self.fde_index, q_fde, cfg.nprobe,
                                 cfg.k_candidates)
            bd.ann_s = self.cost.time(self.fde_index, cfg.nprobe)
        # the FDE inner product sums r_reps independent Chamfer estimates;
        # dividing brings candidate scores onto MaxSim's scale
        scores = scores / float(self.tier.fde.cfg.r_reps)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        tr = self.tracer
        if q_cls.shape[0] == 0:
            bd.hit_rate = 0.0
            return []
        cspan = tr.begin("candidate_gen", cat="compute") \
            if tr is not None else None
        scores, ids = self._fde_candidates(q_bow, q_lens, bd)
        if tr is not None:
            tr.end(cspan, sim_s=bd.ann_s)
        return self._rerank_candidates(q_bow, q_lens, scores, ids, bd)


@register_backend("cascade")
class CascadeBackend(FDEBackend):
    """Three-stage cascade: resident FDE candidate generation (MUVERA) ->
    resident sign-bit filter (Nardini) -> SSD full-precision MaxSim of the
    few survivors. Candidate width is ``cascade_candidates`` (0 =
    ``k_candidates``); only the top ``cascade_filter`` bit-score survivors
    pay SSD bytes."""

    storage_stack = "espn"
    needs_bit_table = True
    needs_fde_table = True

    def _retrieve(self, q_cls, q_bow, q_lens, bd):
        cfg = self.cfg
        tr = self.tracer
        if q_cls.shape[0] == 0:
            bd.hit_rate = 0.0
            return []
        width = cfg.cascade_candidates or cfg.k_candidates
        if width != cfg.k_candidates:
            self.cfg = dataclasses.replace(cfg, k_candidates=width)
        cspan = tr.begin("candidate_gen", cat="compute") \
            if tr is not None else None
        try:
            scores, ids = self._fde_candidates(q_bow, q_lens, bd)
        finally:
            self.cfg = cfg
            if tr is not None:
                tr.end(cspan, sim_s=bd.ann_s)
        return self._bit_filter_rerank(q_bow, q_lens, scores, ids, bd,
                                       cfg.cascade_filter)
