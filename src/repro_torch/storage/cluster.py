"""Sharded, replicated storage cluster with hedged reads.

A single ``StorageTier`` models one device; scale-out serving partitions the
embedding layout across N devices and replicates each partition R ways. This
module supplies that layer *between the retrieval backends and the devices*:

* ``shard_assignments`` / ``build_shard_layout``: block-aligned partitioning
  of an ``EmbeddingLayout`` (round-robin over doc ids, or contiguous ranges
  balanced by block mass). Each shard is a real sub-layout (own blob, own
  offsets table) served by its own ``StorageTier``.
* ``ReplicaClock``: an independent per-replica device clock: the shard
  tier's calibrated read time scaled by a per-replica latency multiplier
  (degraded/slow replicas for straggler scenarios) and an optional lognormal
  jitter draw from the replica's own RNG stream.
* ``hedge_clock``: the hedging primitive (also used by
  ``repro_torch.serve.scheduler.hedged_read``): if the primary replica's
  draw exceeds the configured quantile of the healthy latency distribution,
  the read is re-issued on the best secondary replica and the first arrival
  wins. BOTH reads are billed on the device clock: the duplicate blocks are
  reported separately as ``hedge_bytes``.
* ``StorageCluster``: the ``StorageTier`` read/read_batch/read_bits/
  memory_resident_bytes/close protocol, so every registered retrieval
  backend runs on a cluster unchanged. ``read_batch`` builds ONE global
  ``BatchReadPlan`` (batch-wide dedup, arena in global block order),
  consults the cross-batch ``ArenaCache`` first (hot docs across consecutive
  batches never touch the SSD clock), then routes the remaining arena rows
  to per-shard runs staged concurrently on each shard tier's pool. The batch
  clock is the MAX over the shards' (possibly hedged) effective times (the
  devices operate in parallel) and per-query attribution divides it by
  first-owner uncached blocks, summing exactly to the batch total.

As on the single tier, a read lands its rows in a ``DeviceArena`` on the
cluster's device: raw stored-dtype token rows in one host staging buffer
(pinned on CUDA), each run copied to the device once, on the caller's
thread, when a query first needs it (``ensure_query``). The arena's pool
rows are placed so that every run is one contiguous range: the cache-served
rows first (copied on the caller's thread and uploaded at once), then each
shard's runs in order. Every clock, jitter and fault draw happens on the
caller's thread, in the reference's order; the staging threads only copy
bytes.

The single-tier path is the identity: ``n_shards=1, replication=1``, cache
off, no jitter reproduces ``StorageTier`` bills and rankings bitwise.
"""
from __future__ import annotations

import threading
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np
import torch

from repro_torch.storage import ssd as ssd_lib
from repro_torch.storage.arena_cache import ArenaCache
from repro_torch.storage.batch_io import (BatchReadPlan, BatchReadResult,
                                          DeviceArena, _exclusive_cumsum,
                                          run_chunk, serial_batch, upload)
from repro_torch.storage.faults import (FaultInjector, ShardReadError,
                                        fault_span_counts, zero_fault_stats)
from repro_torch.storage.io_engine import ReadResult, StorageTier
from repro_torch.storage.layout import EmbeddingLayout, stage_rows


# -- partitioning ------------------------------------------------------------

def shard_assignments(layout: EmbeddingLayout, n_shards: int,
                      partition: str = "round_robin") -> np.ndarray:
    """(N,) int32 doc -> shard map. ``round_robin`` interleaves doc ids;
    ``range`` cuts contiguous id ranges with ~equal total block mass."""
    if partition not in ("round_robin", "range"):
        raise ValueError(f"unknown partition policy {partition!r}; "
                         "expected 'round_robin' or 'range'")
    n = layout.n_docs
    if partition == "round_robin":
        return (np.arange(n, dtype=np.int64) % n_shards).astype(np.int32)
    cum = np.cumsum(layout.offsets[:, 1])
    total = int(cum[-1]) if n else 0
    bounds = total * (np.arange(1, n_shards) / n_shards)
    cuts = np.searchsorted(cum, bounds, side="left")
    return np.searchsorted(cuts, np.arange(n), side="right").astype(np.int32)


def build_shard_layout(layout: EmbeddingLayout,
                       global_ids: np.ndarray) -> EmbeddingLayout:
    """Extract one shard's block-aligned sub-layout (own blob + offsets).
    Docs keep their global order within the shard."""
    gids = np.asarray(global_ids, np.int64)
    offs = layout.offsets[gids]
    nb = offs[:, 1]
    starts = _exclusive_cumsum(nb)
    block = layout.block
    total = int(nb.sum())
    if total:
        # one fancy-index gather over the block-reshaped blob
        src_blocks = (np.repeat(offs[:, 0] - _exclusive_cumsum(nb), nb)
                      + np.arange(total, dtype=np.int64))
        blob = layout.blob.reshape(-1, block)[src_blocks].reshape(-1)
    else:
        blob = np.zeros(0, np.uint8)
    offsets = np.stack([starts, nb], axis=1)
    return EmbeddingLayout(
        blob=blob, offsets=offsets, n_tokens=layout.n_tokens[gids],
        d_cls=layout.d_cls, d_bow=layout.d_bow, dtype=layout.dtype,
        scales=layout.scales[gids] if layout.scales is not None else None,
        block=block, mode=layout.mode, stride_blocks=layout.stride_blocks,
        pool_k=layout.pool_k,
        # raw block copies preserve record bytes exactly, so the parent's
        # per-record crc32s stay valid in the sub-layout
        checksums=(layout.checksums[gids]
                   if layout.checksums is not None else None))


# -- replica clocks + hedging ------------------------------------------------

@dataclass
class ReplicaClock:
    """One replica's device clock: the shard tier's calibrated time scaled by
    a latency multiplier (a degraded replica is deliberately slow) and an
    independent lognormal jitter draw (the straggler tail).

    Jitter is keyed by ``(seed_key..., seq)``, one stateless draw per batch
    sequence number, so a replica's draw for batch ``seq`` is the same
    whether it serves as primary or as hedge target: hedged clusters are
    pointwise no slower than unhedged ones under primary rotation."""
    mult: float = 1.0
    jitter_sigma: float = 0.0
    seed_key: tuple = ()

    def draw(self, seq: int = 0) -> float:
        """Multiplicative factor for one read on this replica."""
        f = self.mult
        if self.jitter_sigma > 0.0:
            rng = np.random.default_rng([*self.seed_key, int(seq)])
            f *= float(np.exp(self.jitter_sigma * rng.standard_normal()))
        return f


def hedge_clock(t_primary: float, secondary_fn, hedge_after_s: float):
    """The hedging primitive: if the primary exceeds ``hedge_after_s``, a
    duplicate goes to a replica (``secondary_fn()`` -> its service time) and
    the first arrival wins. Returns ``(effective_s, hedged, win)``."""
    if t_primary <= hedge_after_s:
        return t_primary, False, False
    t_hedged = hedge_after_s + secondary_fn()
    return min(t_primary, t_hedged), True, t_hedged < t_primary


# -- the executed cluster batch ----------------------------------------------

class ClusterBatchReadResult(BatchReadResult):
    """A ``BatchReadResult`` whose runs are per-shard (non-contiguous arena
    rows, each run one contiguous range of pool rows) and whose clock and
    attribution cover only the rows that actually went to a device
    (cache-served rows are free)."""

    def __init__(self, *, plan: BatchReadPlan, sim_seconds: float,
                 n_blocks: int, arena: DeviceArena, staging: torch.Tensor,
                 futures: list[Future], run_ranges: list[tuple[int, int]],
                 run_of_row: np.ndarray | None,
                 owned_io_blocks: np.ndarray, hedge_blocks: int,
                 cache_hits: int, failed_rows: np.ndarray | None = None):
        super().__init__(coalesced=True, plan=plan, sim_seconds=sim_seconds,
                         n_blocks=n_blocks, arena=arena, staging=staging,
                         futures=futures)
        self._run_ranges = run_ranges          # pool rows [a, b) of each run
        self._run_of_row = run_of_row          # (U,) run idx, -1 = cache-fill
        self._owned_io = owned_io_blocks       # (B,) uncached first-owner blocks
        self.hedge_blocks = hedge_blocks
        self.cache_hits = cache_hits
        self._failed_rows = failed_rows        # (U,) bool: rows of a shard
                                               # whose read failed (no rows)

    # -- per-shard failure surface -------------------------------------------
    def query_failed(self, b: int) -> bool:
        if self._failed_rows is None:
            return False
        rows = self.plan.query_rows[b]
        return bool(len(rows)) and bool(self._failed_rows[rows].any())

    def rows_failed(self, rows) -> bool:
        rows = np.asarray(rows, np.int64)
        if self._failed_rows is None or len(rows) == 0:
            return False
        return bool(self._failed_rows[rows].any())

    @property
    def any_failed(self) -> bool:
        return self._failed_rows is not None \
            and bool(self._failed_rows.any())

    # -- synchronization -----------------------------------------------------
    def _run_rows(self, ri: int) -> tuple[int, int]:
        return self._run_ranges[ri]

    def _wait_rows(self, rows: np.ndarray) -> None:
        if self._run_of_row is None or len(rows) == 0:
            return
        runs = np.unique(self._run_of_row[np.asarray(rows, np.int64)])
        self._land(runs[runs >= 0])

    def ensure_query(self, b: int) -> None:
        self._wait_rows(self.plan.query_rows[b])

    def ensure_rows(self, rows) -> None:
        self._wait_rows(np.asarray(rows, np.int64))

    def io_s(self, b: int) -> float:
        total = int(self._owned_io.sum())
        if total == 0:
            return 0.0
        return self.sim_seconds * (float(self._owned_io[b]) / float(total))


# -- the cluster -------------------------------------------------------------

class StorageCluster:
    """N shards x R replicas behind the ``StorageTier`` protocol.

    Data movement is real (each shard owns a sub-layout blob and a thread
    pool); the clock is the shard tier's calibrated model scaled by the
    replica clocks, with hedged re-issue after the ``hedge_quantile`` delay.
    """

    def __init__(self, layout: EmbeddingLayout, *, n_shards: int = 1,
                 replication: int = 1, partition: str = "round_robin",
                 spec: ssd_lib.StorageSpec = ssd_lib.PM983_PCIE3,
                 stack: str = "espn", mem_budget_bytes: int | None = None,
                 t_max: int = 180, qd: int = 64, include_h2d: bool = True,
                 n_io_threads: int = 4, bits=None, fde=None,
                 coalesce: bool = True, io_chunk_docs: int | None = None,
                 replica_mults=None, hedge_quantile: float = 0.0,
                 jitter_sigma: float = 0.0, seed: int = 0,
                 arena_cache_bytes: int = 0,
                 faults: FaultInjector | None = None,
                 shard_layouts: list[tuple[EmbeddingLayout, np.ndarray]]
                 | None = None,
                 tracer=None, device: str | torch.device = "cuda"):
        if n_shards < 1 or replication < 1:
            raise ValueError("n_shards and replication must be >= 1")
        if not 0.0 <= hedge_quantile < 1.0:
            raise ValueError("hedge_quantile must be in [0, 1)")
        mults = list(replica_mults or [])
        if mults and len(mults) != replication:
            raise ValueError(
                f"replica_mults has {len(mults)} entries for "
                f"replication={replication}; give one multiplier per replica "
                "(broadcast across shards)")
        self.layout = layout
        self.tracer = tracer          # repro_torch.obs.Tracer | None (off)
        self.bits = bits
        self.fde = fde
        self.spec = spec
        self.stack = stack
        if layout.mode == "fixed_stride":
            # arena rows sized to the pooled token count, not t_max
            t_max = min(t_max, layout.pool_k)
        self.t_max = t_max
        self.qd = qd
        self.coalesce = coalesce
        self.io_chunk_docs = io_chunk_docs
        self.n_shards = n_shards
        self.replication = replication
        self.partition = partition
        self.hedge_quantile = hedge_quantile
        self.jitter_sigma = jitter_sigma
        self.device = torch.device(device)   # where read arenas live
        self._closed = False
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=n_io_threads,
                                        thread_name_prefix="cluster-io")

        # -- shards: sub-layouts + one StorageTier per shard ----------------
        if shard_layouts is not None:
            if len(shard_layouts) != n_shards:
                raise ValueError(f"{len(shard_layouts)} persisted shard "
                                 f"layouts for n_shards={n_shards}")
            subs = [sl for sl, _ in shard_layouts]
            gid_lists = [np.asarray(g, np.int64) for _, g in shard_layouts]
            self.shard_of = np.full(layout.n_docs, -1, np.int32)
            for s, gids in enumerate(gid_lists):
                self.shard_of[gids] = s
            self._check_shard_cover()
        elif n_shards == 1:
            subs = [layout]                    # zero-copy: the shard IS the
            gid_lists = [np.arange(layout.n_docs, dtype=np.int64)]  # layout
            self.shard_of = np.zeros(layout.n_docs, np.int32)
        else:
            self.shard_of = shard_assignments(layout, n_shards, partition)
            gid_lists = [np.flatnonzero(self.shard_of == s).astype(np.int64)
                         for s in range(n_shards)]
            subs = [build_shard_layout(layout, g) for g in gid_lists]
        self.shard_ids = gid_lists
        self.local_of = np.zeros(layout.n_docs, np.int64)
        for gids in gid_lists:
            self.local_of[gids] = np.arange(len(gids))
        budget = (None if mem_budget_bytes is None
                  else max(1, int(mem_budget_bytes) // n_shards))
        self.shards = [StorageTier(sub, spec=spec, stack=stack,
                                   mem_budget_bytes=budget, t_max=t_max,
                                   qd=qd, include_h2d=include_h2d,
                                   n_io_threads=n_io_threads,
                                   coalesce=coalesce,
                                   io_chunk_docs=io_chunk_docs,
                                   device=self.device)
                       for sub in subs]

        # -- replica clocks + hedge threshold --------------------------------
        self.replicas = [[ReplicaClock(
            mult=float(mults[r]) if mults else 1.0,
            jitter_sigma=jitter_sigma, seed_key=(seed, s, r))
            for r in range(replication)] for s in range(n_shards)]
        # primary rotation: batch ``seq`` reads replica ``seq % replication``
        # on every shard; a dead replica's turn fails over to the healthiest
        # alive peer (hedge timer fires, secondary serves, no bytes doubled)
        self._batch_seq = 0
        self._replica_alive = [[True] * replication for _ in range(n_shards)]
        self._hedge_on = hedge_quantile > 0.0 and replication > 1
        # the hedge delay is the hedge_quantile-quantile of the HEALTHY
        # (mult=1) latency distribution for this read: base_t * this factor
        self._hedge_factor = (
            float(np.exp(jitter_sigma * NormalDist().inv_cdf(hedge_quantile)))
            if self._hedge_on and jitter_sigma > 0.0 else 1.0)

        self.arena_cache = ArenaCache(arena_cache_bytes, d_cls=layout.d_cls)
        # cache inserts deferred from prior batches: flushed (in FIFO batch
        # order, ascending arena rows) before the next batch's probe, so LRU
        # recency stays deterministic WITHOUT joining this batch's staging
        # before read_batch returns (which would forfeit the I/O-overlaps-
        # rerank pipelining)
        self._cache_pending: list[tuple] = []
        self.stats = {"reads": 0, "docs": 0, "doc_requests": 0, "blocks": 0,
                      "sim_seconds": 0.0, "batch_reads": 0, "io_runs": 0,
                      "dedup_docs": 0, "hedged_reads": 0, "hedge_wins": 0,
                      "hedge_bytes": 0, "cache_hits": 0, "cache_misses": 0,
                      "failovers": 0, "replicas_killed": 0,
                      "replicas_recovered": 0, "recovery_bytes": 0,
                      "recovery_seconds": 0.0}
        # fault counters are always present (zero without an injector) so a
        # dead-replica ShardReadError has somewhere to land even when no
        # fault rates are configured
        self.stats.update(zero_fault_stats())
        # injection happens at the replica/cluster level only: the shard
        # tiers themselves are built fault-free above
        self.faults = faults
        self.degrade_reads = faults.cfg.degrade if faults is not None \
            else True

    # -- shard coverage (overridden by the mutation layer) -------------------
    def _check_shard_cover(self) -> None:
        if (self.shard_of < 0).any():
            raise ValueError("persisted shard layouts do not cover the "
                             "full doc-id space")

    # -- clocks --------------------------------------------------------------
    def _next_seq(self) -> int:
        """One batch sequence number per read/read_batch call: keys the
        stateless jitter draws and the primary rotation."""
        with self._lock:
            seq = self._batch_seq
            self._batch_seq += 1
            return seq

    def _best_alive(self, s: int, exclude: int) -> int | None:
        """The healthiest alive replica of shard ``s`` other than
        ``exclude`` (lowest multiplier, lowest index breaks ties)."""
        cands = [r for r in range(self.replication)
                 if r != exclude and self._replica_alive[s][r]]
        if not cands:
            return None
        return min(cands, key=lambda r: (self.replicas[s][r].mult, r))

    def _shard_clock(self, s: int, base_t: float, n_blocks: int, seq: int):
        """One shard read on the device clock: the rotating primary's draw,
        hedged re-issue past the quantile delay, failover past a dead
        primary. Returns ``(effective_s, hedge_blocks, hedged, win,
        failover, fault_events)``; ``fault_events`` is ``None`` unless the
        fault injector fired for this read. Raises ``ShardReadError`` when
        no replica can serve (all dead, or every candidate exhausted its
        retry budget); ``read_batch`` turns that into a per-shard failure
        that only degrades the queries touching this shard."""
        reps = self.replicas[s]
        p = seq % self.replication
        if self.faults is not None and self.faults.cfg.enabled() \
                and self._replica_alive[s][p] \
                and self.faults.any_event(seq, s, p):
            # the retry/failover machine owns the duplicate-issue decision
            # for this read; hedging is bypassed (a read that drew a fault
            # event never also hedges)
            eff, failover, ev = self._shard_clock_faulty(s, base_t, seq)
            return eff, 0, False, False, failover, ev
        if not self._replica_alive[s][p]:
            # dead primary: it never answers, so the hedge timer (or the
            # immediate connection failure when hedging is off) routes the
            # read to the healthiest alive peer. No duplicate bytes move.
            sec = self._best_alive(s, exclude=p)
            if sec is None:
                raise ShardReadError(s, reason="no alive replica")
            t_sec = base_t * reps[sec].draw(seq)
            if self._hedge_on:
                return base_t * self._hedge_factor + t_sec, 0, True, True, \
                    True, None
            return t_sec, 0, False, False, True, None
        t1 = base_t * reps[p].draw(seq)
        if not self._hedge_on or n_blocks == 0:
            return t1, 0, False, False, False, None
        sec = self._best_alive(s, exclude=p)
        if sec is None:
            return t1, 0, False, False, False, None
        hedge_after = base_t * self._hedge_factor
        eff, hedged, win = hedge_clock(
            t1, lambda: base_t * self.replicas[s][sec].draw(seq), hedge_after)
        return eff, (n_blocks if hedged else 0), hedged, win, False, None

    def _shard_clock_faulty(self, s: int, base_t: float, seq: int):
        """Bounded-retry + failover state machine for one shard read that
        drew a fault event. Candidates: the rotating primary, then alive
        peers healthiest-first. Each candidate runs the retry loop (failed
        attempts bill their full read time plus deterministic backoff); a
        flapped candidate is unreachable and fails over immediately.
        Returns ``(effective_s, failover, events)``; raises
        ``ShardReadError`` carrying the seconds already burned when every
        candidate is exhausted."""
        fi = self.faults
        reps = self.replicas[s]
        p = seq % self.replication
        peers = sorted((r for r in range(self.replication)
                        if r != p and self._replica_alive[s][r]),
                       key=lambda r: (reps[r].mult, r))
        cands = ([p] if self._replica_alive[s][p] else []) + peers
        if not cands:
            raise ShardReadError(s, reason="no alive replica")
        ev = zero_fault_stats()
        total = 0.0
        for ci, r in enumerate(cands):
            if fi.flap(seq, s, r):
                ev["replica_flaps"] += 1
                ev["faults_injected"] += 1
                continue
            elapsed, ok = fi.attempt_loop(seq, s, r,
                                          base_t * reps[r].draw(seq), ev)
            total += elapsed
            if ok:
                return total, ci > 0, ev
        raise ShardReadError(s, elapsed_s=total, events=ev)

    def _corruption_event(self, seq: int, s: int, pieces, gids_s):
        """Per-shard-read corruption draw. Returns ``(extra_s, victim,
        events)``: repair seconds to add to the shard clock, the position
        within ``gids_s`` whose staged rows must be corrupted (-1 = no
        corruption, or it was detected and repaired from a healthy
        replica), and the event counters. Detection is the *real* crc32
        check over the flipped wire buffer (``wire_corruption_detected``);
        repair bills one extra device read of the victim record, separate
        from the query's unique-bytes bill."""
        fi = self.faults
        ev = zero_fault_stats()
        if len(gids_s) == 0 or not fi.corrupt(seq, s):
            return 0.0, -1, ev
        ev["corruptions_injected"] += 1
        ev["faults_injected"] += 1
        v = fi.victim(seq, s, len(gids_s))
        # locate the victim's record in whichever routed piece serves it
        lay, lid = None, -1
        for play, local_p, sel in pieces:
            if sel is None:
                lay, lid = play, int(np.asarray(local_p)[v])
                break
            j = np.flatnonzero(np.asarray(sel) == v)
            if len(j):
                lay, lid = play, int(np.asarray(local_p)[int(j[0])])
                break
        if lay is not None and fi.cfg.checksum \
                and fi.wire_corruption_detected(lay, lid):
            ev["checksum_failures"] += 1
            ev["repairs"] += 1
            nbv = lay.blocks_for([lid])
            tier = self.shards[s]
            extra = (ssd_lib.DRAM.read_time(nbv, qd=tier.qd)
                     if tier.stack == "dram"
                     else tier.spec.read_time(nbv, qd=tier.qd))
            ev["repair_bytes"] += nbv * lay.block
            return extra, -1, ev
        return 0.0, v, ev

    # -- replica failure injection / recovery --------------------------------
    def _shard_disk_blocks(self, s: int) -> int:
        """Blocks a fresh replica of shard ``s`` must copy to re-sync (the
        whole on-disk image)."""
        return int(self.shards[s].layout.offsets[:, 1].sum())

    def kill_replica(self, shard: int, replica: int) -> None:
        """Failure injection: mark one replica dead. Its rotation turns fail
        over to the healthiest alive peer until ``recover_replica``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if not 0 <= replica < self.replication:
            raise ValueError(f"replica {replica} out of range")
        with self._lock:
            alive = self._replica_alive[shard]
            if not alive[replica]:
                raise ValueError(
                    f"replica {replica} of shard {shard} is already dead")
            if sum(alive) == 1:
                raise RuntimeError(
                    f"cannot kill the last alive replica of shard {shard}")
            alive[replica] = False
            self.stats["replicas_killed"] += 1

    def recover_replica(self, shard: int, replica: int) -> dict:
        """Bring a killed replica back: re-sync its whole shard image from an
        alive peer. ``recovery_bytes`` counts the image once (the bytes that
        crossed the wire) and ``recovery_seconds`` charges the source read
        plus the symmetric destination write on the shard's device clock,
        separate from the query-path ``sim_seconds``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if not 0 <= replica < self.replication:
            raise ValueError(f"replica {replica} out of range")
        with self._lock:
            if self._replica_alive[shard][replica]:
                raise ValueError(
                    f"replica {replica} of shard {shard} is alive")
            nb = self._shard_disk_blocks(shard)
            secs = 2.0 * self.shards[shard].spec.read_time(nb, self.qd)
            self._replica_alive[shard][replica] = True
            self.stats["replicas_recovered"] += 1
            self.stats["recovery_bytes"] += nb * self.layout.block
            self.stats["recovery_seconds"] += secs
        return {"shard": shard, "replica": replica,
                "bytes": nb * self.layout.block, "seconds": secs}

    def replica_status(self) -> list[list[bool]]:
        """Alive mask per shard x replica (the autoscaler's view of what it
        can recover or kill)."""
        with self._lock:
            return [list(a) for a in self._replica_alive]

    def set_hedge_quantile(self, hedge_quantile: float) -> None:
        """Re-tune hedging at runtime (the autoscaler's knob): recomputes
        the hedge delay factor from the healthy latency distribution, as at
        construction. Lower quantile = hedge earlier = more duplicate bytes
        traded for tail latency."""
        if not 0.0 <= hedge_quantile < 1.0:
            raise ValueError("hedge_quantile must be in [0, 1)")
        with self._lock:
            self.hedge_quantile = hedge_quantile
            self._hedge_on = hedge_quantile > 0.0 and self.replication > 1
            self._hedge_factor = (
                float(np.exp(self.jitter_sigma
                             * NormalDist().inv_cdf(hedge_quantile)))
                if self._hedge_on and self.jitter_sigma > 0.0 else 1.0)

    def _check_open(self):
        if self._closed:
            raise RuntimeError("StorageCluster is closed")

    # -- shard routing (overridden by the mutation layer) --------------------
    def _shard_read_plan(self, s: int, gids: np.ndarray):
        """Route one shard's slice of global doc ids to stageable pieces.

        Returns ``(pieces, base_t, n_blocks)``; each piece is ``(layout,
        local_ids, sel)`` where ``sel`` indexes into ``gids``'s positions
        (``None`` = all of them, in order). The base cluster serves every
        row from the shard's own sub-layout in one piece."""
        local = self.local_of[gids]
        base_t, nb = self.shards[s]._sim_time(local)
        return [(self.shards[s].layout, local, None)], base_t, nb

    # -- arenas --------------------------------------------------------------
    def _new_arena(self, first: np.ndarray, lens: np.ndarray,
                   scales: np.ndarray | None, t_max: int):
        """A read's arena on the cluster's device (row ``u``'s token rows
        start at pool row ``first[u]``) and the host buffer its rows are
        staged in (pinned on CUDA; on the CPU the two are one tensor).
        Caller's thread."""
        dtype = torch.from_numpy(np.empty(0, self.layout.dtype)).dtype
        on_card = self.device.type == "cuda"
        staging = torch.empty((int(lens.sum(dtype=np.int64)),
                               self.layout.d_bow), dtype=dtype,
                              pin_memory=on_card)
        pool = (torch.empty_like(staging, device=self.device) if on_card
                else staging)
        arena = DeviceArena(
            pool=pool, first=torch.as_tensor(first, device=self.device),
            lens=torch.as_tensor(lens, device=self.device),
            scales=(torch.as_tensor(scales, device=self.device)
                    if scales is not None else None),
            t_max=t_max)
        return arena, staging

    def _scales_of(self, ids: np.ndarray) -> np.ndarray | None:
        sc = self.layout.scales
        return (np.array(sc[ids], np.float32, copy=True)
                if sc is not None else None)

    # -- reads ---------------------------------------------------------------
    def read(self, ids, t_max: int | None = None) -> ReadResult:
        """Blocking read in request order (row j = ids[j]). The clock routes
        each shard's slice through its replica clocks (max over shards);
        duplicates are billed per occurrence, exactly like ``StorageTier``.
        Rows come from the shard sub-layouts, placed piece by piece in the
        arena's pool, and are copied to the device before returning."""
        self._check_open()
        seq = self._next_seq()
        ids = np.asarray(ids, np.int64)
        t_max = t_max or self.t_max
        lens = np.minimum(self.layout.n_tokens[ids], t_max).astype(np.int32)
        shard_of_ids = self.shard_of[ids]
        scales = self._scales_of(ids)
        staged: list[tuple] = []       # (layout, local ids, rows) to stage
        corrupt: list[int] = []        # positions whose rows are flipped
        sim, n_blocks, hedge_blocks, hedged, wins = 0.0, 0, 0, 0, 0
        failovers = 0
        fault_ev = zero_fault_stats()
        fault_on = self.faults is not None and self.faults.cfg.enabled()
        if len(ids) == 0:
            # preserve the single-tier empty-read floor (h2d base cost)
            sim, _ = self.shards[0]._sim_time(ids)
            p = seq % self.replication
            if not self._replica_alive[0][p]:
                p = self._best_alive(0, exclude=p)
                if p is None:
                    raise ShardReadError(0, reason="no alive replica")
            sim *= self.replicas[0][p].draw(seq)
        else:
            for s in range(self.n_shards):
                rows = np.flatnonzero(shard_of_ids == s)
                if len(rows) == 0:
                    continue
                pieces, base_t, nb = self._shard_read_plan(s, ids[rows])
                try:
                    eff, hb, h, w, fo, fev = self._shard_clock(
                        s, base_t, nb, seq)
                except ShardReadError as e:
                    # the blocking read serves ONE request: bill the burned
                    # clock + events, then let the caller (serial_batch /
                    # the prefetcher) mark the query failed
                    with self._lock:
                        self.stats["sim_seconds"] += max(sim, e.elapsed_s)
                        self.stats["shard_read_failures"] += 1
                        for k, n in e.events.items():
                            self.stats[k] += n
                    raise
                vic = -1
                if fev is not None:
                    for k, n in fev.items():
                        fault_ev[k] += n
                if fault_on:
                    extra, vic, cev = self._corruption_event(
                        seq, s, pieces, ids[rows])
                    eff += extra
                    for k, n in cev.items():
                        fault_ev[k] += n
                sim = max(sim, eff)
                n_blocks += nb
                hedge_blocks += hb
                hedged += int(h)
                wins += int(w)
                failovers += int(fo)
                for lay, local_p, sel in pieces:
                    staged.append((lay, local_p,
                                   rows if sel is None else rows[sel]))
                if vic >= 0:
                    corrupt.append(int(rows[vic]))
                with self.shards[s]._lock:
                    st = self.shards[s].stats
                    st["reads"] += 1
                    st["docs"] += len(rows)
                    st["doc_requests"] += len(rows)
                    st["blocks"] += nb
                    st["sim_seconds"] += eff
        if scales is not None:
            # undetected wire corruption: the victim's values change sign
            # (the worst case for MaxSim); a scaled layout negates its scale
            for pos in corrupt:
                scales[pos] = -scales[pos]
        # the pieces' rows end to end in the pool: each is one stage_rows
        order = (np.concatenate([r for _, _, r in staged]) if staged
                 else np.empty(0, np.int64))
        first = np.empty(len(ids), np.int64)
        first[order] = _exclusive_cumsum(lens[order].astype(np.int64))
        arena, staging = self._new_arena(first, lens, scales, t_max)
        out = staging.numpy()
        for lay, local_p, rows_p in staged:
            a = int(first[rows_p[0]])
            stage_rows(lay, local_p, t_max,
                       out[a:a + int(lens[rows_p].sum(dtype=np.int64))])
        if scales is None:
            for pos in corrupt:
                a = int(first[pos])
                np.negative(out[a:a + lens[pos]], out=out[a:a + lens[pos]])
        upload(arena, staging, 0, len(staging))
        with self._lock:
            self.stats["reads"] += 1
            self.stats["docs"] += len(ids)
            self.stats["doc_requests"] += len(ids)
            self.stats["blocks"] += n_blocks
            self.stats["sim_seconds"] += sim
            self.stats["hedged_reads"] += hedged
            self.stats["hedge_wins"] += wins
            self.stats["hedge_bytes"] += hedge_blocks * self.layout.block
            self.stats["failovers"] += failovers
            for k, n in fault_ev.items():
                self.stats[k] += n
        return ReadResult(arena, sim, n_blocks)

    def read_async(self, ids, t_max: int | None = None) -> Future:
        self._check_open()
        return self._pool.submit(self.read, ids, t_max)

    def _gather_run(self, layout: EmbeddingLayout, local_ids, t_max: int,
                    out: np.ndarray, corrupt: tuple[int, int] | None = None):
        """Stage one run's token rows into its contiguous range ``out`` of
        the staging buffer (a shard pool thread). ``corrupt`` = the rows
        ``[a, b)`` of ``out`` that an undetected wire corruption flips."""
        stage_rows(layout, local_ids, t_max, out)
        if corrupt is not None:
            a, b = corrupt
            np.negative(out[a:b], out=out[a:b])

    def _cache_insert_ok(self, gid: int) -> bool:
        """Deferred-insert guard: the mutation layer vetoes rows whose doc
        was deleted between the gather and the flush."""
        return True

    def _flush_cache_inserts(self) -> None:
        """Apply deferred cache inserts from earlier batches. Runs on the
        coordinating thread in FIFO batch order / ascending arena rows:
        deterministic LRU recency, so same-seed runs evict identically and
        reproduce identical simulated clocks.

        The joins below are free once the caller has consumed the previous
        batch, but back-to-back ``read_batch`` calls (the espn prefetcher's
        prefetch-then-miss pair) DO wait for the first call's outstanding
        staging when the cache is on: the price of a reproducible clock
        (inserting from the staging threads would make cache contents, and
        so every later batch's clock, depend on thread scheduling). Wall
        clock only; the simulated accounting never includes staging wall
        time."""
        with self._lock:
            pending, self._cache_pending = self._cache_pending, []
        for futures, staging, first, lens, scales, rows, gids in pending:
            try:
                for f in futures:
                    f.result()
            except (Exception, CancelledError):
                # cancelled (closed mid-batch) or failed staging: the OWNING
                # batch already surfaced the failure through its own
                # wait/rerank path; a later batch's flush only skips that
                # batch's inserts
                continue
            out = staging.numpy()
            for row, gid in zip(rows, gids):
                if not self._cache_insert_ok(int(gid)):
                    continue
                a, t = int(first[row]), int(lens[row])
                self.arena_cache.put(
                    int(gid), out[a:a + t], t,
                    float(scales[row]) if scales is not None else None)

    def read_batch(self, per_query_ids, t_max: int | None = None, *,
                   coalesce: bool | None = None,
                   skip_empty: bool = False) -> BatchReadResult:
        """One cluster transaction for a whole query batch.

        Coalesced: ONE global plan (batch-wide dedup, arena in global block
        order); the arena cache serves hot rows from memory first; the rest
        route to per-shard runs staged concurrently on each shard's pool,
        each shard billed once through its replica clocks (hedged re-issue
        past the quantile delay). The batch clock is the max over shards.
        Serial (``coalesce=False``): per-query blocking ``read`` calls.
        """
        self._check_open()
        t_max = t_max or self.t_max
        coalesce = self.coalesce if coalesce is None else coalesce
        tr = self.tracer
        lists = [np.asarray(x, np.int64).ravel() for x in per_query_ids]
        if coalesce:
            seq = self._next_seq()
        if not coalesce:
            # the serial baseline bypasses the arena cache, but earlier
            # coalesced batches' deferred inserts still flush, so no batch
            # arena stays pinned in _cache_pending across a mode switch
            if self.arena_cache.enabled:
                self._flush_cache_inserts()
            if tr is None:
                return serial_batch(lambda ids: self.read(ids, t_max), lists,
                                    skip_empty)
            sp = tr.begin("read_batch", cat="io", serial=True)
            try:
                res = serial_batch(lambda ids: self.read(ids, t_max), lists,
                                   skip_empty)
            except BaseException:
                tr.end(sp, error=True)
                raise
            tr.end(sp, sim_s=res.sim_seconds)
            res.span = sp
            return res
        t_plan0 = tr.clock() if tr is not None else 0.0
        plan = BatchReadPlan.build(self.layout, lists, t_max=t_max,
                                   chunk_docs=self.io_chunk_docs,
                                   with_query_runs=False)
        if tr is not None:
            plan.span = tr.add("plan", cat="io", t0=t_plan0, t1=tr.clock(),
                               n_unique=plan.n_unique,
                               n_blocks=plan.n_blocks)
        u = plan.n_unique
        lens = plan.arena_lens
        if u == 0:
            arena, staging = self._new_arena(plan.arena_first, lens, None,
                                             t_max)
            return ClusterBatchReadResult(
                plan=plan, sim_seconds=0.0, n_blocks=0, arena=arena,
                staging=staging, futures=[], run_ranges=[], run_of_row=None,
                owned_io_blocks=np.zeros(len(lists), np.int64),
                hedge_blocks=0, cache_hits=0)
        scales = self._scales_of(plan.arena_ids)

        # 1) cross-batch arena cache: hot rows are a memory access
        cached = np.zeros(u, bool)
        hits: list = []
        if self.arena_cache.enabled:
            t_c0 = tr.clock() if tr is not None else 0.0
            self._flush_cache_inserts()
            ents = self.arena_cache.get_many(plan.arena_ids, lens)
            for row, ent in enumerate(ents):
                if ent is None:
                    continue
                cached[row] = True
                hits.append(ent[0][:int(lens[row])])
                if scales is not None:
                    scales[row] = ent[1]
            if tr is not None:
                tr.add("cache_probe", cat="io", t0=t_c0, t1=tr.clock(),
                       hits=int(cached.sum()), probed=u)
        cache_hits = int(cached.sum())

        # 2) per-shard clocks and runs over the uncached rows (every draw on
        #    this thread, in shard order); staging is submitted below, once
        #    the pool rows are placed
        run_of_row = np.full(u, -1, np.int64)
        runs: list[tuple] = []         # (shard, layout, local ids, rows, cr)
        sim, hedge_blocks, hedged, wins, io_blocks = 0.0, 0, 0, 0, 0
        failovers = 0
        uncached_rows = np.flatnonzero(~cached)
        shard_of_rows = (self.shard_of[plan.arena_ids[uncached_rows]]
                         if len(uncached_rows) else
                         np.empty(0, np.int32))
        # per-shard requested docs, duplicates included (the StorageTier
        # doc_requests convention): every request for a doc that reached
        # shard s, so shard-level doc_requests - docs = that shard's dedup
        concat = np.concatenate(lists)
        req_mask = np.isin(concat, plan.arena_ids[uncached_rows])
        req_by_shard = np.bincount(self.shard_of[concat[req_mask]],
                                   minlength=self.n_shards)
        fault_ev = zero_fault_stats()
        fault_on = self.faults is not None and self.faults.cfg.enabled()
        failed_rows = None
        for s in range(self.n_shards):
            rows_s = uncached_rows[shard_of_rows == s]
            if len(rows_s) == 0:
                continue
            t_s0 = tr.clock() if tr is not None else 0.0
            gids_s = plan.arena_ids[rows_s]
            pieces, base_t, nb = self._shard_read_plan(s, gids_s)
            try:
                eff, hb, h, w, fo, fev = self._shard_clock(s, base_t, nb,
                                                           seq)
            except ShardReadError as e:
                # per-shard failure: only the queries whose rows live on
                # this shard degrade; the other shards' reads proceed. The
                # burned retry clock still bills (no bytes moved).
                sim = max(sim, e.elapsed_s)
                if failed_rows is None:
                    failed_rows = np.zeros(u, bool)
                failed_rows[rows_s] = True
                for k, n in e.events.items():
                    fault_ev[k] += n
                fault_ev["shard_read_failures"] += 1
                if tr is not None:
                    self._trace_shard(tr, t_s0, s, e.elapsed_s, 0,
                                      e.events or {}, hedged=False,
                                      win=False, failover=False,
                                      hedge_blocks=0, failed=True)
                continue
            vic = -1
            ev_s: dict = dict(fev) if fev else {}
            if fev is not None:
                for k, n in fev.items():
                    fault_ev[k] += n
            if fault_on:
                extra, vic, cev = self._corruption_event(seq, s, pieces,
                                                         gids_s)
                eff += extra
                for k, n in cev.items():
                    fault_ev[k] += n
                    ev_s[k] = ev_s.get(k, 0) + n
            corrupt_arena_row = int(rows_s[vic]) if vic >= 0 else -1
            if corrupt_arena_row >= 0 and scales is not None:
                # a scaled layout negates the victim's scale instead
                scales[corrupt_arena_row] = -scales[corrupt_arena_row]
                corrupt_arena_row = -1
            sim = max(sim, eff)
            io_blocks += nb
            hedge_blocks += hb
            hedged += int(h)
            wins += int(w)
            failovers += int(fo)
            n_runs = 0
            for lay, local_p, sel in pieces:
                rows_p = rows_s if sel is None else rows_s[sel]
                chunk = run_chunk(len(rows_p), self.io_chunk_docs)
                for r0 in range(0, len(rows_p), chunk):
                    sl = slice(r0, r0 + chunk)
                    run_of_row[rows_p[sl]] = len(runs)
                    cr = (corrupt_arena_row if corrupt_arena_row >= 0
                          and (rows_p[sl] == corrupt_arena_row).any()
                          else -1)
                    runs.append((s, lay, local_p[sl], rows_p[sl], cr))
                    n_runs += 1
            with self.shards[s]._lock:
                st = self.shards[s].stats
                st["reads"] += 1
                st["batch_reads"] += 1
                st["io_runs"] += n_runs
                st["docs"] += len(rows_s)
                st["doc_requests"] += int(req_by_shard[s])
                st["dedup_docs"] += int(req_by_shard[s]) - len(rows_s)
                st["blocks"] += nb
                st["sim_seconds"] += eff
            if tr is not None:
                self._trace_shard(tr, t_s0, s, eff, nb, ev_s, hedged=h,
                                  win=w, failover=fo, hedge_blocks=hb)

        # 3) the arena: cache-served rows first, then every run's rows end
        #    to end (a failed shard's rows last, never staged), so each run
        #    is one contiguous range of pool rows
        cached_rows = np.flatnonzero(cached)
        placed = [cached_rows] + [r[3] for r in runs]
        if failed_rows is not None:
            placed.append(np.flatnonzero(failed_rows))
        order = np.concatenate(placed)
        first = np.empty(u, np.int64)
        first[order] = _exclusive_cumsum(lens[order].astype(np.int64))
        arena, staging = self._new_arena(first, lens, scales, t_max)
        out = staging.numpy()
        n_hit = int(lens[cached_rows].sum(dtype=np.int64))
        if n_hit:
            out[:n_hit] = np.concatenate(hits)
            upload(arena, staging, 0, n_hit)
        futures: list[Future] = []
        run_ranges: list[tuple[int, int]] = []
        for s, lay, local_ids, rows_r, cr in runs:
            a = int(first[rows_r[0]])
            b = a + int(lens[rows_r].sum(dtype=np.int64))
            victim = None
            if cr >= 0:
                va = int(first[cr]) - a
                victim = (va, va + int(lens[cr]))
            run_ranges.append((a, b))
            futures.append(self.shards[s]._pool.submit(
                self._gather_run, lay, local_ids, t_max, out[a:b], victim))

        # 4) cache insertion is DEFERRED to the next batch's flush: never
        #    done by the staging workers (scheduling-dependent interleaving
        #    would make LRU recency, evictions and every later batch's clock
        #    nondeterministic across same-seed runs) and never joined here
        #    (that would forfeit the rerank overlap)
        if self.arena_cache.enabled and len(uncached_rows):
            # rows of a failed shard hold nothing: never cache them
            ins_rows = (uncached_rows if failed_rows is None
                        else uncached_rows[~failed_rows[uncached_rows]])
            if len(ins_rows):
                with self._lock:
                    self._cache_pending.append(
                        (futures, staging, first, lens, scales, ins_rows,
                         plan.arena_ids[ins_rows]))

        # 5) attribution: first-owner over the rows that hit a device
        owned_io = np.zeros(len(lists), np.int64)
        if len(uncached_rows):
            np.add.at(owned_io, plan.owner_rows[uncached_rows],
                      plan.arena_blocks[uncached_rows])
        with self._lock:
            self.stats["reads"] += 1
            self.stats["batch_reads"] += 1
            self.stats["io_runs"] += len(futures)
            self.stats["docs"] += u
            self.stats["doc_requests"] += plan.n_requested
            self.stats["dedup_docs"] += plan.n_requested - u
            self.stats["blocks"] += io_blocks
            self.stats["sim_seconds"] += sim
            self.stats["hedged_reads"] += hedged
            self.stats["hedge_wins"] += wins
            self.stats["hedge_bytes"] += hedge_blocks * self.layout.block
            self.stats["failovers"] += failovers
            for k, n in fault_ev.items():
                self.stats[k] += n
            if self.arena_cache.enabled:
                self.stats["cache_hits"] += cache_hits
                self.stats["cache_misses"] += len(uncached_rows)
        res = ClusterBatchReadResult(
            plan=plan, sim_seconds=sim, n_blocks=io_blocks, arena=arena,
            staging=staging, futures=futures, run_ranges=run_ranges,
            run_of_row=run_of_row, owned_io_blocks=owned_io,
            hedge_blocks=hedge_blocks, cache_hits=cache_hits,
            failed_rows=failed_rows)
        if tr is not None:
            res.span = tr.add("read_batch", cat="io", t0=t_plan0,
                              t1=tr.clock(), sim_s=sim, n_unique=u,
                              n_blocks=io_blocks, cache_hits=cache_hits,
                              hedged=hedged, hedge_wins=wins,
                              failovers=failovers)
            res.tracer = tr
        return res

    def read_bits(self, ids, t_max: int | None = None):
        """Resident bit-tier gather (global: side tables are not
        sharded)."""
        if self.bits is None:
            raise RuntimeError(
                "this StorageCluster was built without a resident BitTable; "
                "construct it with bits=pack_bits(...)")
        return self.bits.gather(ids, t_max or self.t_max)

    # -- tracing -------------------------------------------------------------
    def _trace_shard(self, tr, t0: float, s: int, eff: float, nb: int,
                     events: dict, *, hedged: bool, win: bool,
                     failover: bool, hedge_blocks: int,
                     failed: bool = False) -> None:
        """One ``shard_read`` span per shard per batch, with each replica
        attempt that went sideways (hedges, retries, stalls, checksum
        repairs, failovers, flaps) as a child span. Children share the
        parent's wall interval (the device clock is simulated; the wall
        section is the planning work) and appear iff the corresponding
        counter fired."""
        t1 = tr.clock()
        sp = tr.add("shard_read", cat="io", t0=t0, t1=t1, sim_s=eff,
                    shard=s, blocks=nb, failed=failed)
        if hedged:
            tr.add("hedge", cat="io", t0=t0, t1=t1, parent=sp,
                   win=bool(win), blocks=int(hedge_blocks))
        if failover:
            tr.add("failover", cat="fault", t0=t0, t1=t1, parent=sp)
        for name, count in fault_span_counts(events):
            tr.add(name, cat="fault", t0=t0, t1=t1, parent=sp, count=count)

    # -- reporting -----------------------------------------------------------
    def memory_resident_bytes(self) -> int:
        """Host/device memory across the cluster: every shard's resident
        footprint, the global side tables, and the arena-cache budget."""
        total = sum(sh.memory_resident_bytes() for sh in self.shards)
        if self.bits is not None:
            total += self.bits.nbytes
        if self.fde is not None:
            total += self.fde.nbytes
        return total + self.arena_cache.capacity_bytes

    def per_shard_stats(self) -> list[dict]:
        return [dict(sh.stats) for sh in self.shards]

    def metrics_sources(self) -> list:
        """``(prefix, snapshot_fn)`` pairs for a ``MetricsRegistry``: the
        cluster-level counters (hedges, failovers, cache, faults, recovery),
        one source per shard tier, and the arena cache. Pull-time only."""
        def snap():
            with self._lock:
                s = dict(self.stats)
            s["replicas_alive"] = sum(sum(a) for a in self._replica_alive)
            s["memory_resident_bytes"] = self.memory_resident_bytes()
            return s

        def shard_snap(sh):
            def _s():
                with sh._lock:
                    return dict(sh.stats)
            return _s

        out = [("storage_cluster", snap)]
        for i, sh in enumerate(self.shards):
            out.append((f"storage_shard_{i}", shard_snap(sh)))
        if self.arena_cache.enabled:
            out.append(("arena_cache", self.arena_cache.stats))
        return out

    def close(self):
        """Idempotent cluster shutdown: the cluster pool and every shard pool
        cancel their pending futures (callers holding one see CancelledError,
        not a hang); in-flight staging finishes. ``read``/``read_batch``
        after close raise instead of billing: an interrupted batch never
        records phantom hedges."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # release deferred-insert buffers: the final batch's staging
            # would otherwise outlive every BatchReadResult the caller
            # dropped
            self._cache_pending.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)
        for sh in self.shards:
            sh.close()
