"""The ``PipelineConfig`` tree: one declarative description of an ESPN
retrieval stack (corpus -> IVF index -> packed storage layout -> retrieval
backend), with dict and argparse round-trips. Field and flag names are the
reference package's, for the knobs this port carries.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.espn import ESPNConfig
from repro_torch.core.fde import FDEConfig
from repro_torch.pipeline.backends import get_backend
from repro_torch.storage.ssd import DEFAULT_BLOCK


@dataclass
class CorpusConfig:
    """Synthetic corpus parameters (see repro_torch.data.synthetic)."""
    n_docs: int = 20_000
    n_queries: int = 64
    d_cls: int = 128
    d_bow: int = 32
    n_clusters: int = 256
    mean_len: int = 60
    max_len: int = 180
    with_bow: bool = True
    seed: int = 0


@dataclass
class IndexConfig:
    """IVF candidate-generation index. ncells=0 -> auto (~n_docs/270,
    the paper's MS-MARCO docs-per-cell ratio)."""
    ncells: int = 0
    iters: int = 6
    quant: str = "fp32"                # fp32 | fp16 | int8
    train_sample: int = 200_000

    def resolve_ncells(self, n_docs: int) -> int:
        return self.ncells or max(16, n_docs // 270)


@dataclass
class StorageConfig:
    """Block-aligned embedding layout + storage tier. The software stack
    (espn/mmap/swap/dram) is chosen by the retrieval backend, not here."""
    dtype: str = "float16"             # stored element dtype
    block: int = DEFAULT_BLOCK         # device block / alignment size
    t_max: int = 180                   # gather padding (max tokens read back)
    mem_budget_frac: float = 0.25      # page-cache budget for mmap/swap
    bit_dtype: str = "uint32"          # resident bit-table lane dtype
                                       # (uint8/uint16/uint32; bitvec and
                                       # cascade only)
    fde_dtype: str = "float16"         # resident FDE table dtype (fde and
                                       # cascade only)
    io_coalesce: bool = True           # batch I/O engine: dedup + coalesce
                                       # reads across the query batch (False
                                       # = serial per-query reads)
    layout_mode: str = "ragged"        # ragged | fixed_stride (constant-space
                                       # pooled layout: uniform stride,
                                       # offsets computed, zero metadata)
    pool_k: int = 0                    # fixed_stride: tokens per doc after
                                       # cluster pooling (required > 0)
    pool_seed: int = 0                 # pooling k-means seed (content-
                                       # deterministic)


@dataclass
class RetrievalConfig:
    """Which backend runs the query path, and its knobs."""
    mode: str = "espn"
    nprobe: int = 24
    k_candidates: int = 200
    prefetch_step: float = 0.2
    rerank_count: int | None = None    # None = exact re-rank
    alpha: float = 1.0
    bit_filter: int = 128              # bitvec: survivors that get full rerank
    fde_k_sim: int = 3                 # fde: 2^k_sim SimHash buckets per rep
    fde_reps: int = 16                 # fde: partition repetitions
    fde_d_final: int = 256             # fde: final projection dim (0 = raw)
    fde_seed: int = 0                  # fde: partition/projection randomness
    fde_brute_threshold: int = 100_000  # fde: brute-scan below, IVF above
    cascade_filter: int = 64           # cascade: bit survivors reranked on SSD
    cascade_candidates: int = 0        # cascade: FDE candidate width
                                       # (0 = reuse k_candidates)

    def to_espn_config(self) -> ESPNConfig:
        return ESPNConfig(mode=self.mode, nprobe=self.nprobe,
                          k_candidates=self.k_candidates,
                          prefetch_step=self.prefetch_step,
                          rerank_count=self.rerank_count, alpha=self.alpha,
                          bit_filter=self.bit_filter,
                          fde_brute_threshold=self.fde_brute_threshold,
                          cascade_filter=self.cascade_filter,
                          cascade_candidates=self.cascade_candidates)

    def to_fde_config(self, d_bow: int) -> FDEConfig:
        """The encoding family these knobs describe, for a given token dim
        (the layout's d_bow, not a free knob)."""
        return FDEConfig(d_bow=d_bow, k_sim=self.fde_k_sim,
                         r_reps=self.fde_reps, d_final=self.fde_d_final,
                         seed=self.fde_seed)


@dataclass
class PipelineConfig:
    corpus: CorpusConfig = field(default_factory=CorpusConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)

    _SECTIONS = {"corpus": CorpusConfig, "index": IndexConfig,
                 "storage": StorageConfig, "retrieval": RetrievalConfig}

    # -- dict round-trip ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        unknown = set(d) - set(cls._SECTIONS)
        if unknown:
            raise KeyError(f"unknown PipelineConfig sections {sorted(unknown)}; "
                           f"expected {sorted(cls._SECTIONS)}")
        return cls(**{name: sec(**d[name])
                      for name, sec in cls._SECTIONS.items() if name in d})

    # -- argparse round-trip -------------------------------------------------
    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
        c, i, s, r = (CorpusConfig(), IndexConfig(), StorageConfig(),
                      RetrievalConfig())
        ap.add_argument("--docs", type=int, default=c.n_docs)
        ap.add_argument("--queries", type=int, default=c.n_queries)
        ap.add_argument("--d-cls", type=int, default=c.d_cls)
        ap.add_argument("--d-bow", type=int, default=c.d_bow)
        ap.add_argument("--clusters", type=int, default=c.n_clusters)
        ap.add_argument("--seed", type=int, default=c.seed)
        ap.add_argument("--ncells", type=int, default=i.ncells,
                        help="IVF cells (0 = auto ~docs/270)")
        ap.add_argument("--iters", type=int, default=i.iters)
        ap.add_argument("--quant", default=i.quant,
                        choices=["fp32", "fp16", "int8"])
        ap.add_argument("--dtype", default=s.dtype)
        ap.add_argument("--bit-dtype", default=s.bit_dtype,
                        choices=["uint8", "uint16", "uint32"],
                        help="resident bit-table lane dtype (bitvec and "
                             "cascade modes)")
        ap.add_argument("--t-max", type=int, default=s.t_max)
        ap.add_argument("--mem-budget-frac", type=float,
                        default=s.mem_budget_frac)
        ap.add_argument("--layout-mode", default=s.layout_mode,
                        choices=["ragged", "fixed_stride"],
                        help="storage layout: ragged (per-doc offsets) or "
                             "fixed_stride (constant-space pooled layout; "
                             "requires --pool-k)")
        ap.add_argument("--pool-k", type=int, default=s.pool_k,
                        help="fixed_stride: pooled token vectors per doc")
        ap.add_argument("--pool-seed", type=int, default=s.pool_seed,
                        help="fixed_stride: pooling k-means seed")
        ap.add_argument("--serial-io", action="store_true",
                        help="disable the coalesced batch I/O engine "
                             "(per-query serial reads; duplicates billed "
                             "per requesting query)")
        ap.add_argument("--mode", default=r.mode,
                        help="retrieval backend (espn, gds, mmap, swap, "
                             "dram, bitvec, fde, cascade, cspn; validated "
                             "against the registry)")
        ap.add_argument("--nprobe", type=int, default=r.nprobe)
        ap.add_argument("--k", type=int, default=r.k_candidates)
        ap.add_argument("--prefetch-step", type=float, default=r.prefetch_step)
        ap.add_argument("--rerank", type=int, default=0,
                        help="partial re-rank count (0 = exact)")
        ap.add_argument("--alpha", type=float, default=r.alpha)
        ap.add_argument("--bit-filter", type=int, default=r.bit_filter,
                        help="bitvec: top-R bit-score survivors that get "
                             "full-precision re-rank")
        ap.add_argument("--fde-k-sim", type=int, default=r.fde_k_sim,
                        help="fde: SimHash bits per repetition "
                             "(2^k buckets)")
        ap.add_argument("--fde-reps", type=int, default=r.fde_reps,
                        help="fde: independent partition repetitions")
        ap.add_argument("--fde-d-final", type=int, default=r.fde_d_final,
                        help="fde: final random-projection dim (0 = raw "
                             "reps * 2^k * d_bow concatenation)")
        ap.add_argument("--fde-seed", type=int, default=r.fde_seed,
                        help="fde: partition/projection randomness seed")
        ap.add_argument("--fde-brute-threshold", type=int,
                        default=r.fde_brute_threshold,
                        help="fde: brute-scan the FDE table below this "
                             "corpus size, IVF-over-FDEs above it")
        ap.add_argument("--fde-dtype", default=s.fde_dtype,
                        choices=["float16", "float32"],
                        help="resident FDE table dtype (fde and cascade "
                             "modes)")
        ap.add_argument("--cascade-filter", type=int,
                        default=r.cascade_filter,
                        help="cascade: bit-score survivors that reach the "
                             "SSD rerank stage")
        ap.add_argument("--cascade-candidates", type=int,
                        default=r.cascade_candidates,
                        help="cascade: FDE candidate-generation width "
                             "(0 = reuse --k)")
        return ap

    @classmethod
    def from_cli(cls, args: argparse.Namespace) -> "PipelineConfig":
        try:
            get_backend(args.mode)
        except KeyError as e:
            raise SystemExit(f"error: {e.args[0]}") from None
        return cls(
            corpus=CorpusConfig(n_docs=args.docs, n_queries=args.queries,
                                d_cls=args.d_cls, d_bow=args.d_bow,
                                n_clusters=args.clusters, seed=args.seed),
            index=IndexConfig(ncells=args.ncells, iters=args.iters,
                              quant=args.quant),
            storage=StorageConfig(dtype=args.dtype, t_max=args.t_max,
                                  mem_budget_frac=args.mem_budget_frac,
                                  bit_dtype=args.bit_dtype,
                                  fde_dtype=args.fde_dtype,
                                  io_coalesce=not args.serial_io,
                                  layout_mode=args.layout_mode,
                                  pool_k=args.pool_k,
                                  pool_seed=args.pool_seed),
            retrieval=RetrievalConfig(mode=args.mode, nprobe=args.nprobe,
                                      k_candidates=args.k,
                                      prefetch_step=args.prefetch_step,
                                      rerank_count=args.rerank or None,
                                      alpha=args.alpha,
                                      bit_filter=args.bit_filter,
                                      fde_k_sim=args.fde_k_sim,
                                      fde_reps=args.fde_reps,
                                      fde_d_final=args.fde_d_final,
                                      fde_seed=args.fde_seed,
                                      fde_brute_threshold=(
                                          args.fde_brute_threshold),
                                      cascade_filter=args.cascade_filter,
                                      cascade_candidates=(
                                          args.cascade_candidates)))
