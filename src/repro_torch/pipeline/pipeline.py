"""``Pipeline``: the user-facing construction API for the ported ESPN stack.

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:   # device="cuda"
        resp = pipe.search()                         # corpus queries
        print(pipe.evaluate())                       # MRR/recall + breakdown

The retrieval mode is resolved against the backend registry
(``repro_torch.pipeline.backends``), which also decides the storage-tier
software stack, whether a page-cache memory budget applies, and which
resident side tables the tier carries (the sign-bit table for ``bitvec``/
``cascade``, the FDE table for ``fde``/``cascade``). The storage layout is
the paper's ``ragged`` one or, with ``storage.layout_mode="fixed_stride"``,
the constant-space layout of a corpus pooled to ``storage.pool_k`` tokens a
doc. The IVF index, the FDE table and each read's token rows live on
``device``; the packed layout and the bit table are host arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.espn import ComputeModel, RetrievalResponse
from repro_torch.core.pool import pool_corpus
from repro_torch.core.fde import FDETable, fde_from_layout
from repro_torch.core.ivf import ANNCostModel, IVFIndex, build_ivf
from repro_torch.core.metrics import mrr_at_k, recall_at_k
from repro_torch.data.synthetic import Corpus, make_corpus
from repro_torch.device import resolve_device
from repro_torch.pipeline.backends import RetrievalBackend, get_backend
from repro_torch.pipeline.config import PipelineConfig
from repro_torch.storage.io_engine import StorageTier
from repro_torch.storage.layout import (LAYOUT_MODES, BitTable,
                                        EmbeddingLayout, bits_from_layout,
                                        pack)


def _pack_layout(cfg: PipelineConfig, cls_embs: np.ndarray,
                 bow_embs: list[np.ndarray]) -> EmbeddingLayout:
    """Pack per the config's layout mode. ``fixed_stride`` pools every
    document to exactly ``pool_k`` token vectors first (deterministic
    content-seeded k-means), then packs at a uniform block stride."""
    s = cfg.storage
    if s.layout_mode not in LAYOUT_MODES:
        raise ValueError(f"unknown layout_mode {s.layout_mode!r}; expected "
                         f"one of {LAYOUT_MODES}")
    if s.layout_mode == "fixed_stride":
        if s.pool_k <= 0:
            raise ValueError("layout_mode='fixed_stride' requires "
                             "storage.pool_k > 0 (--pool-k)")
        bow_embs = pool_corpus(bow_embs, s.pool_k, seed=s.pool_seed)
        return pack(cls_embs, bow_embs, dtype=np.dtype(s.dtype),
                    block=s.block, mode="fixed_stride", pool_k=s.pool_k)
    return pack(cls_embs, bow_embs, dtype=np.dtype(s.dtype), block=s.block)


class Pipeline:
    """A built retrieval stack: corpus + index + storage tier + backend."""

    def __init__(self, cfg: PipelineConfig, *, corpus: Corpus | None,
                 index: IVFIndex, layout: EmbeddingLayout, tier: StorageTier,
                 backend: RetrievalBackend):
        self.cfg = cfg
        self.corpus = corpus
        self.index = index
        self.layout = layout
        self.tier = tier
        self.backend = backend

    @property
    def device(self) -> torch.device:
        return self.index.device

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, cfg: PipelineConfig | None = None, *,
              corpus: Corpus | None = None,
              cost_model: ANNCostModel | None = None,
              compute: ComputeModel | None = None,
              device: str | torch.device = "cuda") -> "Pipeline":
        """Build the full stack from config on ``device`` (the card unless
        the caller asks for the CPU). Pass ``corpus`` to reuse an existing
        one; otherwise one is synthesized from ``cfg.corpus``."""
        cfg = cfg or PipelineConfig()
        dev = resolve_device(device)
        get_backend(cfg.retrieval.mode)
        if corpus is None:
            c = cfg.corpus
            corpus = make_corpus(n_docs=c.n_docs, n_queries=c.n_queries,
                                 d_cls=c.d_cls, d_bow=c.d_bow,
                                 n_clusters=c.n_clusters, mean_len=c.mean_len,
                                 max_len=c.max_len, with_bow=c.with_bow,
                                 seed=c.seed)
        index = build_ivf(corpus.cls,
                          ncells=cfg.index.resolve_ncells(corpus.n_docs),
                          iters=cfg.index.iters, quant=cfg.index.quant,
                          train_sample=cfg.index.train_sample, device=dev)
        layout = _pack_layout(cfg, corpus.cls, corpus.bow)
        return cls._assemble(cfg, corpus, index, layout,
                             cost_model=cost_model, compute=compute)

    @classmethod
    def from_artifacts(cls, cfg: PipelineConfig, *, index: IVFIndex,
                       layout: EmbeddingLayout, corpus: Corpus | None = None,
                       cost_model: ANNCostModel | None = None,
                       compute: ComputeModel | None = None,
                       bits: BitTable | None = None,
                       fde: FDETable | None = None,
                       device: str | torch.device = "cuda") -> "Pipeline":
        """Assemble a pipeline around prebuilt artifacts (e.g. the reference
        package's index, layout and side tables carried over by
        ``repro_torch.convert``) — no clustering, no packing. The index is
        moved to ``device``. A side table the backend needs and the caller
        did not pass (or an FDE table of another encoding family or dtype)
        is built from the layout."""
        dev = resolve_device(device)
        return cls._assemble(cfg, corpus, index.to(dev), layout,
                             cost_model=cost_model, compute=compute,
                             bits=bits, fde=fde)

    @classmethod
    def _assemble(cls, cfg: PipelineConfig, corpus: Corpus | None,
                  index: IVFIndex, layout: EmbeddingLayout, *,
                  cost_model=None, compute=None, bits: BitTable | None = None,
                  fde: FDETable | None = None) -> "Pipeline":
        backend_cls = get_backend(cfg.retrieval.mode)
        budget = (int(layout.nbytes * cfg.storage.mem_budget_frac)
                  if backend_cls.needs_mem_budget else None)
        if backend_cls.needs_bit_table:
            if bits is None:
                bits = bits_from_layout(layout, dtype=cfg.storage.bit_dtype)
        else:
            bits = None       # don't bill the bit table to other backends
        if backend_cls.needs_fde_table:
            want = cfg.retrieval.to_fde_config(layout.d_bow)
            if fde is None or not fde.matches(want, cfg.storage.fde_dtype):
                fde = fde_from_layout(layout, want,
                                      dtype=cfg.storage.fde_dtype,
                                      device=index.device)
        else:
            fde = None        # don't bill the FDE table to other backends
        tier = StorageTier(layout, stack=backend_cls.storage_stack,
                           t_max=cfg.storage.t_max, mem_budget_bytes=budget,
                           bits=bits, fde=fde,
                           coalesce=cfg.storage.io_coalesce,
                           device=index.device)
        backend = backend_cls(index, tier, cfg.retrieval.to_espn_config(),
                              cost_model=cost_model, compute=compute)
        return cls(cfg, corpus=corpus, index=index, layout=layout, tier=tier,
                   backend=backend)

    # -- queries ------------------------------------------------------------
    def search(self, q_cls: np.ndarray | None = None,
               q_bow: np.ndarray | None = None,
               q_lens: np.ndarray | None = None) -> RetrievalResponse:
        """Run the retrieval path. With no arguments, uses the corpus's
        bundled query set."""
        if q_cls is None:
            if self.corpus is None:
                raise ValueError("no corpus attached; pass explicit queries")
            q_cls, q_bow, q_lens = (self.corpus.queries_cls,
                                    self.corpus.queries_bow,
                                    self.corpus.query_lens)
        return self.backend.query_batch(q_cls, q_bow, q_lens)

    def evaluate(self, qrels: list[set] | None = None, *,
                 response: RetrievalResponse | None = None,
                 mrr_k: int = 10, recall_k: int = 100) -> dict:
        """Score against qrels; searches the corpus queries unless an
        existing ``response`` (for those queries) is supplied."""
        if qrels is None:
            if self.corpus is None:
                raise ValueError("no corpus attached; pass explicit qrels")
            qrels = self.corpus.qrels
        resp = response or self.search()
        ranked = [r.doc_ids for r in resp.ranked]
        return {f"mrr@{mrr_k}": mrr_at_k(ranked, qrels, mrr_k),
                f"recall@{recall_k}": recall_at_k(ranked, qrels, recall_k),
                "breakdown_ms": resp.breakdown.ms()}

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        self.tier.close()

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc):
        self.close()

