"""The ``PipelineConfig`` tree: one declarative description of an ESPN
retrieval stack (corpus -> IVF index -> packed storage layout -> retrieval
backend -> serving policy), with dict and argparse round-trips. Sections,
fields, defaults and flags are the reference package's, so a ``config.json``
saved by either package loads in the other.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.espn import ESPNConfig
from repro_torch.core.fde import FDEConfig
from repro_torch.pipeline.backends import get_backend
from repro_torch.storage.faults import FaultConfig
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
    k_return: int = 100                # the reference's field; no stage
                                       # reads it in either package
    use_pallas: bool = False           # the reference's Pallas switch, kept
                                       # so its configs load: the port runs
                                       # its CUDA kernels either way
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
class ClusterConfig:
    """Sharded/replicated storage cluster
    (``repro_torch.storage.cluster``). The defaults are the single-tier
    identity: a plain ``StorageTier`` is built unless any scale-out knob is
    set."""
    n_shards: int = 1                  # layout partitions (one tier each)
    replication: int = 1               # replicas per shard (clock-only)
    partition: str = "round_robin"     # round_robin | range (by block mass)
    hedge_quantile: float = 0.0        # re-issue a lagging shard read past
                                       # this quantile (0 = no hedging)
    jitter_sigma: float = 0.0          # lognormal device-clock jitter sigma
    replica_mults: list = field(default_factory=list)
                                       # per-replica latency multipliers
                                       # (empty = all healthy)
    arena_cache_mb: float = 0.0        # cross-batch doc-row cache budget
    seed: int = 0                      # per-replica clock RNG seed

    def enabled(self) -> bool:
        """True when any knob leaves the single-tier identity path."""
        return (self.n_shards > 1 or self.replication > 1
                or self.hedge_quantile > 0.0 or self.jitter_sigma > 0.0
                or self.arena_cache_mb > 0.0
                or any(m != 1.0 for m in self.replica_mults))

    def arena_cache_bytes(self) -> int:
        return int(self.arena_cache_mb * 2**20)


@dataclass
class MutationConfig:
    """Live index mutation (``repro_torch.storage.mutation``). The defaults
    build the immutable tier; ``enabled`` (or any maintenance knob) builds
    a ``MutableStorageCluster`` with ``Pipeline.ingest/delete/compact/
    rebalance/maintain``. A mutable cluster that never mutates ranks and
    bills as the immutable one bit for bit."""
    enabled: bool = False              # build the mutable cluster
    auto_compact_segments: int = 0     # compact a shard at this many
                                       # segments (0 = off)
    auto_compact_dead_frac: float = 0.0  # compact past this dead-block
                                       # fraction (0 = off)
    compact_interval_s: float = 0.0    # background compactor period
    rebalance_skew: float = 0.0        # rebalance past this max/min live
                                       # block mass (0 = off)

    def active(self) -> bool:
        """True when the pipeline should build the mutable tier."""
        return (self.enabled or self.auto_compact_segments > 0
                or self.auto_compact_dead_frac > 0.0
                or self.compact_interval_s > 0.0
                or self.rebalance_skew > 0.0)


@dataclass
class ServeConfig:
    """Serving policy (``repro_torch.serve``). ``slo_ms=0`` keeps the static
    ``BatchPolicy``; setting it builds a deadline-aware ``SLOPolicy`` (EDF
    dispatch, slack-aware early dispatch, queue-depth dynamic batch sizing,
    load-shedding admission control), and ``autoscale`` attaches the
    hedge/replica feedback controller (requires a cluster tier)."""
    max_batch: int = 12                # dispatch cap (paper eq. 4 threshold)
    max_wait_s: float = 0.005
    slo_ms: float = 0.0                # per-request deadline budget
                                       # (0 = no SLO: static policy)
    deadline_aware: bool = True        # EDF + slack-aware dispatch
    dynamic_batch: bool = True         # size batches from queue depth
    shed: bool = True                  # admission control (predicted misses
                                       # rejected, counted as shed)
    shed_margin: float = 1.0           # forecast multiplier before shedding
    slack_frac: float = 0.25           # dispatch when slack < frac * budget
    autoscale: bool = False            # p99-vs-SLO hedge/replica controller
    autoscale_window: int = 64         # sliding latency window (requests)
    autoscale_interval_s: float = 0.25  # min seconds between decisions
    autoscale_fault_trigger: int = 0   # injected-fault events per window
                                       # that force a scale-up (0 = off)


@dataclass
class ObsConfig:
    """Observability (``repro_torch.obs``): per-query span tracing and
    metrics exposition. Off by default; a traced run ranks and bills
    bitwise as an untraced one (tracing records, it never steers)."""
    trace: bool = False                # attach a Tracer to the whole stack
    trace_path: str = ""               # export Chrome/Perfetto trace JSON
                                       # here after evaluate/serve
    metrics_path: str = ""             # write Prometheus-style metrics text
                                       # here after evaluate/serve

    def enabled(self) -> bool:
        """A tracer should be built and threaded through the stack."""
        return self.trace or bool(self.trace_path)


@dataclass
class PipelineConfig:
    corpus: CorpusConfig = field(default_factory=CorpusConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    mutation: MutationConfig = field(default_factory=MutationConfig)
    faults: FaultConfig = field(default_factory=FaultConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    _SECTIONS = {"corpus": CorpusConfig, "index": IndexConfig,
                 "storage": StorageConfig, "retrieval": RetrievalConfig,
                 "cluster": ClusterConfig, "mutation": MutationConfig,
                 "faults": FaultConfig, "serve": ServeConfig,
                 "obs": ObsConfig}

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
        c, i, s, r, v = (CorpusConfig(), IndexConfig(), StorageConfig(),
                         RetrievalConfig(), ServeConfig())
        cl = ClusterConfig()
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
        ap.add_argument("--shards", type=int, default=cl.n_shards,
                        help="storage cluster: shard the layout across this "
                             "many tiers (1 = single-tier identity)")
        ap.add_argument("--replication", type=int, default=cl.replication,
                        help="storage cluster: replicas per shard")
        ap.add_argument("--partition", default=cl.partition,
                        choices=["round_robin", "range"],
                        help="shard partitioning policy")
        ap.add_argument("--hedge-quantile", type=float,
                        default=cl.hedge_quantile,
                        help="re-issue lagging shard reads on a replica past "
                             "this latency quantile (0 = no hedging)")
        ap.add_argument("--cluster-jitter", type=float,
                        default=cl.jitter_sigma,
                        help="lognormal device-clock jitter sigma "
                             "(straggler tail)")
        ap.add_argument("--replica-mults", default="",
                        help="comma-separated per-replica latency "
                             "multipliers, e.g. '4.0,1.0' = degraded primary")
        ap.add_argument("--arena-cache-mb", type=float,
                        default=cl.arena_cache_mb,
                        help="cross-batch arena cache budget in MB (0 = off)")
        ap.add_argument("--cluster-seed", type=int, default=cl.seed,
                        help="replica clock RNG seed")
        m = MutationConfig()
        ap.add_argument("--mutation", action="store_true",
                        help="build the mutable storage cluster (online "
                             "ingest/delete/compact/rebalance)")
        ap.add_argument("--auto-compact-segments", type=int,
                        default=m.auto_compact_segments,
                        help="maintain(): compact a shard at this many "
                             "append segments (0 = off)")
        ap.add_argument("--auto-compact-dead-frac", type=float,
                        default=m.auto_compact_dead_frac,
                        help="maintain(): compact past this dead-block "
                             "fraction (0 = off)")
        ap.add_argument("--compact-interval-s", type=float,
                        default=m.compact_interval_s,
                        help="background compactor period in seconds "
                             "(0 = no daemon)")
        ap.add_argument("--rebalance-skew", type=float,
                        default=m.rebalance_skew,
                        help="maintain(): rebalance shards when max/min "
                             "live block mass exceeds this (0 = off)")
        f = FaultConfig()
        ap.add_argument("--fault-rate", type=float,
                        default=f.read_error_rate,
                        help="per-attempt transient read-error probability "
                             "(0 = fault injection off)")
        ap.add_argument("--fault-stall-rate", type=float,
                        default=f.stall_rate,
                        help="per-read tail-latency stall probability")
        ap.add_argument("--fault-stall-ms", type=float, default=f.stall_ms,
                        help="extra device-clock ms a stall adds")
        ap.add_argument("--fault-corruption-rate", type=float,
                        default=f.corruption_rate,
                        help="per-read bit-flip wire-corruption probability")
        ap.add_argument("--fault-flap-rate", type=float, default=f.flap_rate,
                        help="per-read replica-flap (momentary outage) "
                             "probability")
        ap.add_argument("--fault-seed", type=int, default=f.seed,
                        help="fault-schedule RNG seed")
        ap.add_argument("--read-retries", type=int, default=f.read_retries,
                        help="retry budget per storage read before failover/"
                             "failure")
        ap.add_argument("--retry-backoff-ms", type=float,
                        default=f.retry_backoff_ms,
                        help="base exponential retry backoff (device-clock "
                             "ms)")
        ap.add_argument("--checksum", action="store_true",
                        help="crc32 per doc record: verify on read, repair "
                             "corrupted records from a healthy copy")
        ap.add_argument("--no-degrade", action="store_true",
                        help="fail queries whose storage read exhausted its "
                             "retry budget instead of answering degraded "
                             "from resident scores")
        ap.add_argument("--max-batch", type=int, default=v.max_batch)
        ap.add_argument("--max-wait-s", type=float, default=v.max_wait_s)
        ap.add_argument("--slo-ms", type=float, default=v.slo_ms,
                        help="per-request deadline budget in ms (0 = no "
                             "SLO: static batching policy)")
        ap.add_argument("--static-serve", action="store_true",
                        help="with --slo-ms: keep the static policy "
                             "(no EDF / shedding / dynamic batch) — the "
                             "SLO is still measured, just not acted on")
        ap.add_argument("--shed-margin", type=float, default=v.shed_margin,
                        help="admission forecast multiplier (<1 optimistic, "
                             ">1 conservative)")
        ap.add_argument("--slack-frac", type=float, default=v.slack_frac,
                        help="dispatch early when a deadline's slack drops "
                             "under this fraction of its budget")
        ap.add_argument("--autoscale", action="store_true",
                        help="attach the p99-vs-SLO hedge/replica "
                             "autoscaler (requires cluster knobs)")
        ap.add_argument("--autoscale-window", type=int,
                        default=v.autoscale_window,
                        help="autoscaler sliding latency window (requests)")
        ap.add_argument("--autoscale-interval-s", type=float,
                        default=v.autoscale_interval_s,
                        help="minimum seconds between autoscaler decisions")
        ap.add_argument("--autoscale-fault-trigger", type=int,
                        default=v.autoscale_fault_trigger,
                        help="injected-fault events per window that force a "
                             "scale-up even at healthy p99 (0 = off)")
        ap.add_argument("--trace", action="store_true",
                        help="attach a span tracer to the stack (rankings "
                             "and bills stay bitwise-identical)")
        ap.add_argument("--trace-json", default="", metavar="PATH",
                        help="export the trace as Chrome/Perfetto "
                             "trace-event JSON to PATH (implies --trace)")
        ap.add_argument("--metrics-out", default="", metavar="PATH",
                        help="write Prometheus-style metrics text to PATH")
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
                                          args.cascade_candidates)),
            cluster=ClusterConfig(
                n_shards=args.shards, replication=args.replication,
                partition=args.partition,
                hedge_quantile=args.hedge_quantile,
                jitter_sigma=args.cluster_jitter,
                replica_mults=[float(x) for x in
                               args.replica_mults.split(",") if x],
                arena_cache_mb=args.arena_cache_mb, seed=args.cluster_seed),
            mutation=MutationConfig(
                enabled=args.mutation,
                auto_compact_segments=args.auto_compact_segments,
                auto_compact_dead_frac=args.auto_compact_dead_frac,
                compact_interval_s=args.compact_interval_s,
                rebalance_skew=args.rebalance_skew),
            faults=FaultConfig(read_error_rate=args.fault_rate,
                               stall_rate=args.fault_stall_rate,
                               stall_ms=args.fault_stall_ms,
                               corruption_rate=args.fault_corruption_rate,
                               flap_rate=args.fault_flap_rate,
                               read_retries=args.read_retries,
                               retry_backoff_ms=args.retry_backoff_ms,
                               checksum=args.checksum,
                               degrade=not args.no_degrade,
                               seed=args.fault_seed),
            serve=ServeConfig(max_batch=args.max_batch,
                              max_wait_s=args.max_wait_s,
                              slo_ms=args.slo_ms,
                              deadline_aware=not args.static_serve,
                              dynamic_batch=not args.static_serve,
                              shed=not args.static_serve,
                              shed_margin=args.shed_margin,
                              slack_frac=args.slack_frac,
                              autoscale=args.autoscale,
                              autoscale_window=args.autoscale_window,
                              autoscale_interval_s=(
                                  args.autoscale_interval_s),
                              autoscale_fault_trigger=(
                                  args.autoscale_fault_trigger)),
            obs=ObsConfig(trace=args.trace or bool(args.trace_json),
                          trace_path=args.trace_json,
                          metrics_path=args.metrics_out))
