"""``Pipeline``: the user-facing construction API for the ported ESPN stack.

    from repro_torch.pipeline import Pipeline, PipelineConfig

    with Pipeline.build(PipelineConfig()) as pipe:   # device="cuda"
        resp = pipe.search()                         # corpus queries
        print(pipe.evaluate())                       # MRR/recall + breakdown
        pipe.save("artifacts/")                      # index, layout, tables
    with Pipeline.load("artifacts/") as pipe:        # no re-clustering
        server = pipe.serve()                        # continuous batching

The retrieval mode is resolved against the backend registry
(``repro_torch.pipeline.backends``), which also decides the storage-tier
software stack, whether a page-cache memory budget applies, and which
resident side tables the tier carries (the sign-bit table for ``bitvec``/
``cascade``, the FDE table for ``fde``/``cascade``). The storage layout is
the paper's ``ragged`` one or, with ``storage.layout_mode="fixed_stride"``,
the constant-space layout of a corpus pooled to ``storage.pool_k`` tokens a
doc. The IVF index, the FDE table and each read's token rows live on
``device``; the packed layout and the bit table are host arrays.

``cfg.cluster`` shards and replicates the layout behind a
``StorageCluster`` (hedged reads, the cross-batch arena cache, replica
failover; ``kill_replica``/``recover_replica``), and ``cfg.serve.autoscale``
attaches the feedback autoscaler that drives its replicas. ``cfg.faults``
attaches the seeded fault injector (and record checksums) to the storage
tier, and ``cfg.obs`` a tracer to the whole stack. ``cfg.mutation`` builds
the ``MutableStorageCluster`` (even on one shard and one replica: the
segment machinery lives there), and ``ingest``/``delete``/``compact``/
``rebalance``/``maintain`` change the index while it serves; ``ingest``
also adds the new docs to the IVF index on its device. ``save``/``load``
keep a mutable tier in the reference's ``mutation/`` directory (each
shard's base image, its append segments and the tombstone mask).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.core.espn import ComputeModel, RetrievalResponse
from repro_torch.core.pool import pool_corpus
from repro_torch.core.fde import FDETable, fde_from_layout
from repro_torch.core.ivf import ANNCostModel, IVFIndex, build_ivf, ivf_add
from repro_torch.core.metrics import mrr_at_k, recall_at_k
from repro_torch.data.synthetic import Corpus, make_corpus
from repro_torch.device import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.pipeline import persist
from repro_torch.pipeline.backends import RetrievalBackend, get_backend
from repro_torch.pipeline.config import PipelineConfig
from repro_torch.storage.cluster import StorageCluster
from repro_torch.storage.faults import FaultInjector, add_checksums
from repro_torch.storage.io_engine import StorageTier
from repro_torch.storage.layout import (LAYOUT_MODES, BitTable,
                                        EmbeddingLayout, bits_from_layout,
                                        pack)
from repro_torch.storage.mutation import MutableStorageCluster
from repro_torch.storage.segments import Segment


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
                    block=s.block, mode="fixed_stride", pool_k=s.pool_k,
                    checksum=cfg.faults.checksum)
    return pack(cls_embs, bow_embs, dtype=np.dtype(s.dtype), block=s.block,
                checksum=cfg.faults.checksum)


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
    def from_embeddings(cls, cfg: PipelineConfig, cls_embs: np.ndarray,
                        bow_embs: list[np.ndarray], *,
                        cost_model: ANNCostModel | None = None,
                        compute: ComputeModel | None = None,
                        device: str | torch.device = "cuda") -> "Pipeline":
        """Index externally encoded embeddings (e.g. a trained encoder's
        corpus pass) on ``device``: builds the IVF index and the packed
        layout, no synthetic corpus. Queries must then be passed to
        ``search`` explicitly."""
        dev = resolve_device(device)
        get_backend(cfg.retrieval.mode)
        index = build_ivf(cls_embs,
                          ncells=cfg.index.resolve_ncells(len(cls_embs)),
                          iters=cfg.index.iters, quant=cfg.index.quant,
                          train_sample=cfg.index.train_sample, device=dev)
        layout = _pack_layout(cfg, cls_embs, bow_embs)
        return cls._assemble(cfg, None, index, layout,
                             cost_model=cost_model, compute=compute)

    @classmethod
    def from_artifacts(cls, cfg: PipelineConfig, *, index: IVFIndex,
                       layout: EmbeddingLayout, corpus: Corpus | None = None,
                       cost_model: ANNCostModel | None = None,
                       compute: ComputeModel | None = None,
                       bits: BitTable | None = None,
                       fde: FDETable | None = None, shard_layouts=None,
                       device: str | torch.device = "cuda") -> "Pipeline":
        """Assemble a pipeline around prebuilt artifacts (e.g. the reference
        package's index, layout and side tables carried over by
        ``repro_torch.convert``) — no clustering, no packing. The index is
        moved to ``device``. A side table the backend needs and the caller
        did not pass (or an FDE table of another encoding family or dtype)
        is built from the layout. ``shard_layouts`` hands a cluster its
        prebuilt ``(sub-layout, global ids)`` pairs, as ``with_mode``
        does."""
        dev = resolve_device(device)
        return cls._assemble(cfg, corpus, index.to(dev), layout,
                             cost_model=cost_model, compute=compute,
                             bits=bits, fde=fde, shard_layouts=shard_layouts)

    @classmethod
    def _assemble(cls, cfg: PipelineConfig, corpus: Corpus | None,
                  index: IVFIndex, layout: EmbeddingLayout, *,
                  cost_model=None, compute=None, bits: BitTable | None = None,
                  fde: FDETable | None = None,
                  shard_layouts=None, segments=None,
                  alive=None) -> "Pipeline":
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
        fl = cfg.faults
        faults = FaultInjector(fl) if fl.active() else None
        if fl.checksum:
            # every image the read path serves from needs its checksum
            # column (a handed-down layout may predate --checksum)
            for lay in ([layout] + [sl for sl, _ in (shard_layouts or [])]
                        + [seg.layout for segs in (segments or [])
                           for seg in segs]):
                if lay.checksums is None:
                    add_checksums(lay)
        cl, mu = cfg.cluster, cfg.mutation
        if mu.active() or cl.enabled():
            kw = dict(n_shards=cl.n_shards, replication=cl.replication,
                      partition=cl.partition,
                      stack=backend_cls.storage_stack,
                      mem_budget_bytes=budget, t_max=cfg.storage.t_max,
                      bits=bits, fde=fde, coalesce=cfg.storage.io_coalesce,
                      replica_mults=cl.replica_mults,
                      hedge_quantile=cl.hedge_quantile,
                      jitter_sigma=cl.jitter_sigma, seed=cl.seed,
                      arena_cache_bytes=cl.arena_cache_bytes(),
                      shard_layouts=shard_layouts, faults=faults,
                      device=index.device)
        if mu.active():
            # mutation rides on the cluster tier even for the trivial
            # 1-shard/1-replica config (the routing and segment machinery
            # live there); an unmutated mutable cluster ranks and bills as
            # the immutable path bit for bit
            tier = MutableStorageCluster(
                layout, **kw, segments=segments, alive=alive,
                auto_compact_segments=mu.auto_compact_segments,
                auto_compact_dead_frac=mu.auto_compact_dead_frac,
                compact_interval_s=mu.compact_interval_s,
                rebalance_skew=mu.rebalance_skew,
                pool_seed=cfg.storage.pool_seed)
        elif cl.enabled():
            tier = StorageCluster(layout, **kw)
        else:
            tier = StorageTier(layout, stack=backend_cls.storage_stack,
                               t_max=cfg.storage.t_max,
                               mem_budget_bytes=budget, bits=bits, fde=fde,
                               coalesce=cfg.storage.io_coalesce,
                               faults=faults, device=index.device)
        backend = backend_cls(index, tier, cfg.retrieval.to_espn_config(),
                              cost_model=cost_model, compute=compute)
        pipe = cls(cfg, corpus=corpus, index=index, layout=layout, tier=tier,
                   backend=backend)
        if cfg.obs.enabled():
            pipe.attach_tracer(Tracer())
        return pipe

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

    # -- observability -------------------------------------------------------
    @property
    def tracer(self) -> Tracer | None:
        """The stack's tracer (None unless ``cfg.obs`` enabled tracing or a
        server attached one)."""
        return self.backend.tracer

    def attach_tracer(self, tracer: Tracer | None) -> None:
        """Thread one tracer through the whole stack (the backend, its
        prefetcher and the storage tier), so that backend spans and storage
        spans (plan/read_batch + fault children) stitch per query; ``None``
        detaches it."""
        self.backend.attach_tracer(tracer)

    def export_trace(self, path: str) -> int:
        """Write the accumulated spans as Chrome/Perfetto trace-event JSON
        (load via chrome://tracing or https://ui.perfetto.dev). Returns the
        event count."""
        tr = self.tracer
        if tr is None:
            raise RuntimeError("no tracer attached; set cfg.obs.trace=True "
                               "(--trace / --trace-json) when building")
        return tr.export(path)

    def metrics_text(self) -> str:
        """Prometheus-style exposition of the storage tier's counters."""
        reg = MetricsRegistry()
        reg.register_sources(self.tier.metrics_sources())
        return reg.expose()

    # -- live mutation -------------------------------------------------------
    def _mutable_tier(self) -> MutableStorageCluster:
        if not isinstance(self.tier, MutableStorageCluster):
            raise RuntimeError(
                "live mutation requires the mutable tier; set "
                "cfg.mutation.enabled=True (or --mutation) when building")
        return self.tier

    def ingest(self, cls_embs: np.ndarray, bow_embs: list[np.ndarray], *,
               scales=None) -> np.ndarray:
        """Add documents online: appends a block-aligned segment on the
        lightest shard, extends the side tables, inserts the docs into the
        IVF index on its device (no re-clustering) and notifies the
        backend. Returns their global ids."""
        tier = self._mutable_tier()
        gids = tier.ingest(cls_embs, bow_embs, scales=scales)
        self.layout = tier.layout           # grown doc-id space
        ivf_add(self.index, np.asarray(cls_embs, np.float32), gids)
        self.backend.on_mutation(ingested=gids)
        return gids

    def delete(self, ids) -> int:
        """Tombstone documents: they stop appearing in results at once;
        their blocks are reclaimed by the next ``compact()``."""
        tier = self._mutable_tier()
        n = tier.delete(ids)
        self.backend.on_mutation(deleted=np.asarray(ids, np.int64))
        return n

    def compact(self, shard: int | None = None) -> dict:
        """Merge append segments and drop dead rows (one shard or all)."""
        return self._mutable_tier().compact(shard)

    def rebalance(self, skew_threshold: float | None = None) -> dict:
        """Migrate live blocks from the heaviest shard to the lightest."""
        return self._mutable_tier().rebalance(skew_threshold)

    def maintain(self) -> dict:
        """One self-management pass (threshold compaction + rebalance)."""
        return self._mutable_tier().maintain()

    # -- serving -------------------------------------------------------------
    def serve(self, policy=None, *, trace_path: str | None = None):
        """Start a continuous-batching ``RetrievalServer`` over this stack.
        ``cfg.serve.slo_ms > 0`` builds the deadline-aware ``SLOPolicy``
        (EDF + admission control) instead of the static ``BatchPolicy``, and
        ``cfg.serve.autoscale`` attaches the hedge/replica feedback
        controller (cluster tier required). ``trace_path`` (or
        ``cfg.obs.trace_path``) traces every request and exports Perfetto
        JSON there at ``shutdown()``. The caller owns ``shutdown()``."""
        from repro_torch.serve.autoscaler import Autoscaler, AutoscalerConfig
        from repro_torch.serve.engine import RetrievalServer
        from repro_torch.serve.scheduler import BatchPolicy
        from repro_torch.serve.slo import SLOPolicy
        sc = self.cfg.serve
        if policy is None:
            if sc.slo_ms > 0:
                policy = SLOPolicy(
                    max_batch=sc.max_batch, max_wait_s=sc.max_wait_s,
                    slo_ms=sc.slo_ms, deadline_aware=sc.deadline_aware,
                    dynamic_batch=sc.dynamic_batch, shed=sc.shed,
                    shed_margin=sc.shed_margin, slack_frac=sc.slack_frac)
            else:
                policy = BatchPolicy(max_batch=sc.max_batch,
                                     max_wait_s=sc.max_wait_s)
        scaler = None
        if sc.autoscale:
            if not isinstance(self.tier, StorageCluster):
                raise RuntimeError(
                    "autoscaling requires the cluster tier; set cluster "
                    "knobs (e.g. --replication 2) when building")
            slo = sc.slo_ms or getattr(policy, "slo_ms", 0.0)
            if not slo:
                raise RuntimeError("autoscaling needs an SLO; set "
                                   "cfg.serve.slo_ms (--slo-ms)")
            scaler = Autoscaler(self.tier, AutoscalerConfig(
                slo_ms=slo, window=sc.autoscale_window,
                interval_s=sc.autoscale_interval_s,
                fault_trigger=sc.autoscale_fault_trigger))
        trace_path = trace_path or self.cfg.obs.trace_path or None
        tracer = self.tracer
        if tracer is None and (trace_path or self.cfg.obs.enabled()):
            tracer = Tracer()
        return RetrievalServer(self.backend, policy=policy,
                               autoscaler=scaler, tracer=tracer,
                               trace_path=trace_path)

    def with_mode(self, mode: str, **retrieval_overrides) -> "Pipeline":
        """A new ``Pipeline`` sharing this one's corpus, index and layout but
        running another backend (the paper's mode comparisons). The bit and
        FDE tables already built, and a cluster's shard sub-layouts (a
        mutable tier's segments and tombstones too), are handed over as
        they are, not copied or rebuilt. The new pipeline owns its own
        storage tier; close both."""
        cfg = PipelineConfig.from_dict(self.cfg.to_dict())
        cfg.retrieval.mode = mode
        valid = {f.name for f in dataclasses.fields(cfg.retrieval)}
        for k, v in retrieval_overrides.items():
            if k not in valid:
                raise TypeError(f"unknown RetrievalConfig field {k!r}; "
                                f"expected one of {sorted(valid)}")
            setattr(cfg.retrieval, k, v)
        shard_layouts = segments = alive = None
        if isinstance(self.tier, StorageCluster):
            # cluster knobs are not retrieval overrides: the new pipeline
            # shards identically, so reuse the already-built sub-layouts
            shard_layouts = list(zip((sh.layout for sh in self.tier.shards),
                                     self.tier.shard_ids))
        if isinstance(self.tier, MutableStorageCluster):
            # segments and tombstones carry over too: the mode comparison
            # must see the same live corpus (layouts are immutable, so the
            # Segment objects are shared)
            segments = [list(segs) for segs in self.tier.segments]
            alive = self.tier.alive
        return self._assemble(cfg, self.corpus, self.index, self.layout,
                              cost_model=self.backend.cost,
                              compute=self.backend.compute,
                              bits=self.tier.bits, fde=self.tier.fde,
                              shard_layouts=shard_layouts,
                              segments=segments, alive=alive)

    # -- persistence ---------------------------------------------------------
    def save(self, out_dir: str) -> str:
        """Write ``config.json``, the index, the layout (with its record
        checksums), the corpus when one is attached and the resident tables
        this pipeline carries, in the reference's format; a mutable tier
        adds its ``mutation/`` directory (the tombstone mask and segment
        counts, each shard's base image, each segment), a sharded cluster
        its ``shards/`` sub-layouts."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(self.cfg.to_dict(), f, indent=1)
        persist.save_index(self.index, os.path.join(out_dir, "index.npz"))
        persist.save_layout(self.layout, os.path.join(out_dir, "layout.npz"))
        if self.corpus is not None:
            persist.save_corpus(self.corpus,
                                os.path.join(out_dir, "corpus.npz"))
        if self.tier.bits is not None:
            persist.save_bits(self.tier.bits,
                              os.path.join(out_dir, "bits.npz"))
        if self.tier.fde is not None:
            persist.save_fde(self.tier.fde,
                             os.path.join(out_dir, "fde.npz"))
        if isinstance(self.tier, MutableStorageCluster):
            # the mutation state replaces the plain shards/ directory: the
            # base sub-layouts have diverged from a fresh partition (ingest,
            # compaction, migration), so every shard keeps its base image,
            # its append segments, and the tombstone mask rides along
            t = self.tier
            mdir = os.path.join(out_dir, "mutation")
            os.makedirs(mdir, exist_ok=True)
            persist.atomic_savez(
                os.path.join(mdir, "state.npz"), alive=t.alive,
                seg_counts=np.array([len(s) for s in t.segments], np.int64))
            for s, sh in enumerate(t.shards):
                persist.save_shard_layout(
                    sh.layout, t.shard_ids[s],
                    os.path.join(mdir, f"shard_{s}.npz"))
                for k, seg in enumerate(t.segments[s]):
                    persist.save_shard_layout(
                        seg.layout, seg.global_ids,
                        os.path.join(mdir, f"seg_{s}_{k}.npz"))
        elif isinstance(self.tier, StorageCluster) and self.tier.n_shards > 1:
            shard_dir = os.path.join(out_dir, "shards")
            os.makedirs(shard_dir, exist_ok=True)
            for s, sh in enumerate(self.tier.shards):
                persist.save_shard_layout(
                    sh.layout, self.tier.shard_ids[s],
                    os.path.join(shard_dir, f"shard_{s}.npz"))
        return out_dir

    @classmethod
    def load(cls, out_dir: str, *, mode: str | None = None,
             cost_model=None, compute=None,
             device: str | torch.device = "cuda") -> "Pipeline":
        """Rebuild a saved stack (this package's or the reference's) on
        ``device`` without re-clustering or re-packing. ``mode`` overrides
        the saved retrieval backend. A saved mutable tier comes back with
        its shard images, segments and tombstones, and goes on mutating
        from the grown doc-id space."""
        dev = resolve_device(device)
        with open(os.path.join(out_dir, "config.json")) as f:
            cfg = PipelineConfig.from_dict(json.load(f))
        if mode is not None:
            cfg.retrieval.mode = mode
        index = persist.load_index(os.path.join(out_dir, "index.npz"), dev)
        layout = persist.load_layout(os.path.join(out_dir, "layout.npz"))

        def optional(name, loader, *args):
            path = os.path.join(out_dir, name)
            return loader(path, *args) if os.path.exists(path) else None
        shard_layouts = segments = alive = None
        mdir = os.path.join(out_dir, "mutation")
        shard_dir = os.path.join(out_dir, "shards")
        n_shards = cfg.cluster.n_shards
        if cfg.mutation.active() and os.path.isdir(mdir):
            z = persist.verified_load(os.path.join(mdir, "state.npz"))
            alive, seg_counts = z["alive"], z["seg_counts"]
            shard_layouts = [persist.load_shard_layout(
                os.path.join(mdir, f"shard_{s}.npz")) for s in range(n_shards)]
            segments = [[Segment(*persist.load_shard_layout(
                            os.path.join(mdir, f"seg_{s}_{k}.npz")))
                         for k in range(int(seg_counts[s]))]
                        for s in range(n_shards)]
        elif cfg.cluster.enabled() and os.path.isdir(shard_dir):
            paths = [os.path.join(shard_dir, f"shard_{s}.npz")
                     for s in range(n_shards)]
            if all(os.path.exists(p) for p in paths):
                shard_layouts = [persist.load_shard_layout(p) for p in paths]
        return cls._assemble(cfg, optional("corpus.npz", persist.load_corpus),
                             index, layout, cost_model=cost_model,
                             compute=compute,
                             bits=optional("bits.npz", persist.load_bits),
                             fde=optional("fde.npz", persist.load_fde, dev),
                             shard_layouts=shard_layouts,
                             segments=segments, alive=alive)

    # -- replica control ------------------------------------------------------
    def kill_replica(self, shard: int, replica: int) -> None:
        if not isinstance(self.tier, StorageCluster):
            raise RuntimeError("replica control requires the cluster tier")
        self.tier.kill_replica(shard, replica)

    def recover_replica(self, shard: int, replica: int) -> dict:
        if not isinstance(self.tier, StorageCluster):
            raise RuntimeError("replica control requires the cluster tier")
        return self.tier.recover_replica(shard, replica)

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        self.tier.close()

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc):
        self.close()

