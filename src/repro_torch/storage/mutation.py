"""Live index mutation: online ingest/delete over the storage cluster.

``MutableStorageCluster`` extends ``StorageCluster`` with the lifecycle a
served index needs:

* **Ingest** appends new documents as per-shard block-aligned *segments*
  (``repro_torch.storage.segments``); the base shard blobs are never
  rewritten. A query spanning the base layout and k segments pays k+1
  device reads on the same simulated clock as base reads, so read
  amplification grows with segment count until compaction. The side tables
  stay consistent: the new docs' sign bits (host) and FDEs (on the table's
  device) are appended from the packed, storage-quantized rows, so they
  equal a from-scratch ``bits_from_layout`` / ``fde_from_layout`` of the
  grown corpus bit for bit.
* **Delete** is a tombstone: the doc's bit in ``alive`` flips, its cached
  arena row is invalidated, and candidate generation, bit filtering and the
  rerank mask it out (``repro_torch.core.ivf.mask_dead``). No data moves
  until compaction reclaims the dead blocks.
* **Compaction** merges a shard's base rows and segments minus tombstones
  into one fresh block-aligned run (raw block copies, bit-exact). The merge
  runs outside the routing lock against immutable blobs, so queries keep
  serving; only the pointer swap is locked. A read captures the layouts of
  its pieces when it is planned, and the staging threads copy from those,
  so in-flight gathers keep the layout they were submitted against. Billed
  as live bytes read and written on the shard's device clock, apart from
  query ``sim_seconds``.
* **Rebalancing** migrates docs from the heaviest shard (by live block
  mass) to the lightest as a migration segment on the destination, both
  sides billed (``migration_bytes`` counts read + write).
* **Replica failure/recovery** lives on the base class (``kill_replica`` /
  ``recover_replica``); this class only extends the re-sync bill to cover
  segment blocks, since a replica mirrors the whole shard image.

With no mutations applied, routing is exactly the base cluster's plan (one
piece per shard, the same clock calls), so a mutable cluster that never
mutates ranks and bills as ``StorageCluster`` bit for bit. Every clock and
draw stays on the caller's thread, in the reference's order; the layouts,
segments and routing arrays are host numpy, as in the reference.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.fde import FDEEncoder
from repro_torch.core.pool import pool_tokens
from repro_torch.storage import ssd as ssd_lib
from repro_torch.storage.cluster import StorageCluster
from repro_torch.storage.layout import pack, unpack_doc
from repro_torch.storage.segments import (Segment, concat_layouts,
                                          merge_rows)

_COMPACT_RETRIES = 5


class MutableStorageCluster(StorageCluster):
    """A ``StorageCluster`` whose corpus can change while it serves."""

    def __init__(self, layout, *, auto_compact_segments: int = 0,
                 auto_compact_dead_frac: float = 0.0,
                 compact_interval_s: float = 0.0,
                 rebalance_skew: float = 0.0,
                 pool_seed: int = 0,
                 segments: list[list[Segment]] | None = None,
                 alive: np.ndarray | None = None, **kw):
        super().__init__(layout, **kw)
        # fixed-stride layouts pool incoming docs with this seed — the same
        # seed a from-scratch rebuild would use (churn == rebuild oracle)
        self.pool_seed = int(pool_seed)
        self.auto_compact_segments = int(auto_compact_segments)
        self.auto_compact_dead_frac = float(auto_compact_dead_frac)
        self.compact_interval_s = float(compact_interval_s)
        self.rebalance_skew = float(rebalance_skew)
        n = layout.n_docs
        self.alive = (np.asarray(alive, bool).copy() if alive is not None
                      else np.ones(n, bool))
        if len(self.alive) != n:
            raise ValueError("alive mask does not match the doc-id space")
        self.seg_of = np.full(n, -1, np.int32)
        self.segments: list[list[Segment]] = [[] for _ in
                                              range(self.n_shards)]
        if segments is not None:
            for s, segs in enumerate(segments):
                for seg in segs:
                    self._attach_segment(s, seg)
        if (self.alive & (self.shard_of < 0)).any():
            raise ValueError("persisted shard layouts + segments do not "
                             "cover every alive doc id")
        # routing lock: reads snapshot the routing arrays + layouts under
        # it; mutations update them under it. Gathers and reranks run
        # outside (layouts captured at submit), so queries keep pipelining.
        self._mut_lock = threading.RLock()
        self._shard_version = [0] * self.n_shards
        self.stats.update({
            "ingests": 0, "ingested_docs": 0, "ingest_bytes": 0,
            "ingest_seconds": 0.0, "deletes": 0, "tombstones": 0,
            "compactions": 0, "compaction_bytes": 0,
            "compaction_seconds": 0.0, "rebalances": 0,
            "migration_bytes": 0, "migration_seconds": 0.0})
        self._fde_encoder = None
        self._compactor = None
        self._compactor_stop = threading.Event()
        if self.compact_interval_s > 0:
            self._compactor = threading.Thread(
                target=self._compact_loop, daemon=True,
                name="cluster-compactor")
            self._compactor.start()

    # restore order: segments attach after super().__init__, so the base
    # coverage check must wait for them (re-checked above against ``alive``)
    def _check_shard_cover(self) -> None:
        pass

    def _attach_segment(self, s: int, seg: Segment) -> None:
        g = np.asarray(seg.global_ids, np.int64)
        self.seg_of[g] = len(self.segments[s])
        self.shard_of[g] = s
        self.local_of[g] = np.arange(len(g))
        self.segments[s].append(seg)

    def _fde_enc(self) -> FDEEncoder:
        """The FDE table's encoder, on the table's device (made once)."""
        if self._fde_encoder is None:
            self._fde_encoder = FDEEncoder(self.fde.cfg, self.fde.vecs.device)
        return self._fde_encoder

    # -- reads: routing under the mutation lock ------------------------------
    def read(self, ids, t_max=None):
        with self._mut_lock:
            return super().read(ids, t_max)

    def read_batch(self, per_query_ids, t_max=None, *, coalesce=None,
                   skip_empty: bool = False):
        with self._mut_lock:
            return super().read_batch(per_query_ids, t_max,
                                      coalesce=coalesce,
                                      skip_empty=skip_empty)

    def _segment_sim_time(self, s: int, seg: Segment, local) -> tuple:
        """A segment read is its own device transaction (base latency +
        transfer on the shard's spec) — k segments touched means k extra
        seeks, the read amplification compaction removes. The O/S-path page
        cache covers only the base image; segments are always direct."""
        tier = self.shards[s]
        nb = int(seg.layout.offsets[np.asarray(local, np.int64), 1].sum())
        if tier.stack == "dram":
            t = ssd_lib.DRAM.read_time(nb, qd=tier.qd)
        else:
            t = tier.spec.read_time(nb, qd=tier.qd)
            if tier.include_h2d:
                t += ssd_lib.h2d_time(nb * seg.layout.block)
        return t, nb

    def _shard_read_plan(self, s: int, gids: np.ndarray):
        so = self.seg_of[gids]
        if not (so >= 0).any():           # pure base read: the base plan
            return super()._shard_read_plan(s, gids)
        pieces, total_t, total_nb = [], 0.0, 0
        base_sel = np.flatnonzero(so < 0)
        if len(base_sel):
            local = self.local_of[gids[base_sel]]
            t, nb = self.shards[s]._sim_time(local)
            pieces.append((self.shards[s].layout, local, base_sel))
            total_t += t
            total_nb += nb
        for k in np.unique(so[so >= 0]):
            sel = np.flatnonzero(so == k)
            seg = self.segments[s][int(k)]
            local = self.local_of[gids[sel]]
            t, nb = self._segment_sim_time(s, seg, local)
            pieces.append((seg.layout, local, sel))
            total_t += t
            total_nb += nb
        return pieces, total_t, total_nb

    def _cache_insert_ok(self, gid: int) -> bool:
        # a doc deleted between the gather and the deferred flush must not
        # resurface from the arena cache
        return bool(self.alive[gid])

    def _shard_disk_blocks(self, s: int) -> int:
        # a replica mirrors the whole shard image: base + every segment
        # (dead rows included — tombstones are logical, the blocks are real)
        return super()._shard_disk_blocks(s) + sum(
            seg.n_blocks for seg in self.segments[s])

    def _live_block_mass(self) -> np.ndarray:
        sel = self.alive & (self.shard_of >= 0)
        return np.bincount(
            self.shard_of[sel], weights=self.layout.offsets[sel, 1],
            minlength=self.n_shards).astype(np.int64)

    # -- ingest --------------------------------------------------------------
    def ingest(self, cls_embs, bow_embs, scales=None) -> np.ndarray:
        """Append new documents online. Returns their global doc ids.

        The rows are packed into one block-aligned segment (same dtype,
        scales regime, and block size as the base layout) appended to the
        shard with the least live block mass; the write is billed on that
        shard's device clock as ``ingest_bytes`` / ``ingest_seconds``,
        separate from query time. ``BitTable``/``FDETable`` side tiers are
        extended from the packed rows so they equal a from-scratch rebuild.
        """
        cls_embs = np.asarray(cls_embs, np.float32)
        bows = [np.asarray(b, np.float32) for b in bow_embs]
        if len(bows) == 0:
            return np.zeros(0, np.int64)
        tr = self.tracer
        t_mut0 = tr.clock() if tr is not None else 0.0
        with self._mut_lock:
            self._check_open()
            # segments inherit the base layout's integrity tier: checksums
            # computed at ingest time, so concat/compaction keep the whole
            # grown corpus verifiable
            ck = self.layout.checksums is not None
            if self.layout.mode == "fixed_stride":
                # pool to the layout's fixed k first — content-seeded, so
                # the segment rows are bit-identical to what a from-scratch
                # rebuild over the grown corpus would pack
                bows = [pool_tokens(b, self.layout.pool_k,
                                    seed=self.pool_seed) for b in bows]
                seg_layout = pack(cls_embs, bows, dtype=self.layout.dtype,
                                  scales=scales, block=self.layout.block,
                                  mode="fixed_stride",
                                  pool_k=self.layout.pool_k, checksum=ck)
            else:
                seg_layout = pack(cls_embs, bows, dtype=self.layout.dtype,
                                  scales=scales, block=self.layout.block,
                                  checksum=ck)
            n0 = self.layout.n_docs
            n_new = len(bows)
            gids = np.arange(n0, n0 + n_new, dtype=np.int64)
            s = int(np.argmin(self._live_block_mass()))
            self.layout = concat_layouts([self.layout, seg_layout],
                                         like=self.layout)
            self.shard_of = np.concatenate(
                [self.shard_of, np.full(n_new, s, np.int32)])
            self.local_of = np.concatenate(
                [self.local_of, np.arange(n_new, dtype=np.int64)])
            self.seg_of = np.concatenate(
                [self.seg_of,
                 np.full(n_new, len(self.segments[s]), np.int32)])
            self.alive = np.concatenate([self.alive, np.ones(n_new, bool)])
            self.segments[s].append(Segment(seg_layout, gids))
            if self.bits is not None or self.fde is not None:
                # the packed (storage-quantized) rows, NOT the fp32 inputs:
                # incremental side tiers must match what a rebuild from the
                # grown layout would see
                bows_q = [unpack_doc(seg_layout, i)[1] for i in range(n_new)]
                if self.bits is not None:
                    self.bits.append(bows_q)
                if self.fde is not None:
                    self.fde.append(self._fde_enc().encode_docs(bows_q))
            nb = int(seg_layout.offsets[:, 1].sum())
            self._shard_version[s] += 1
            write_s = self.shards[s].spec.read_time(nb, qd=self.qd)
            with self._lock:
                self.stats["ingests"] += 1
                self.stats["ingested_docs"] += n_new
                self.stats["ingest_bytes"] += nb * self.layout.block
                self.stats["ingest_seconds"] += write_s
            if tr is not None:
                tr.add("ingest", cat="mutation", t0=t_mut0, t1=tr.clock(),
                       sim_s=write_s, docs=n_new, blocks=nb, shard=s)
            return gids

    # -- delete --------------------------------------------------------------
    def delete(self, ids) -> int:
        """Tombstone documents: no data moves, the ids just stop existing
        for candidate gen, filtering, re-rank, and the arena cache. Blocks
        are reclaimed by the next compaction of their shard."""
        ids = np.unique(np.asarray(ids, np.int64))
        if len(ids) == 0:
            return 0
        tr = self.tracer
        t_mut0 = tr.clock() if tr is not None else 0.0
        with self._mut_lock:
            self._check_open()
            if (ids < 0).any() or ids[-1] >= len(self.alive):
                raise ValueError("delete: doc id out of range")
            if not self.alive[ids].all():
                dead = ids[~self.alive[ids]]
                raise ValueError(f"delete: docs already deleted: "
                                 f"{dead[:8].tolist()}")
            # join deferred inserts first, so a pending arena row for a
            # just-deleted doc cannot land in the cache afterwards (the
            # flush-time guard would also veto it; this keeps ordering
            # deterministic)
            if self.arena_cache.enabled:
                self._flush_cache_inserts()
            self.alive[ids] = False
            self.arena_cache.remove(ids)
            for s in np.unique(self.shard_of[ids]):
                if s >= 0:
                    self._shard_version[int(s)] += 1
            with self._lock:
                self.stats["deletes"] += 1
                self.stats["tombstones"] += len(ids)
        if tr is not None:
            tr.add("delete", cat="mutation", t0=t_mut0, t1=tr.clock(),
                   docs=len(ids))
        return len(ids)

    # -- compaction ----------------------------------------------------------
    def _live_pieces(self, s: int):
        """Snapshot of shard ``s``'s live rows as merge_rows pieces."""
        base_gids = self.shard_ids[s]
        keep = (self.alive[base_gids] & (self.shard_of[base_gids] == s)
                & (self.seg_of[base_gids] < 0))
        rows = np.flatnonzero(keep)
        pieces = [(self.shards[s].layout, rows, base_gids[rows])]
        for k, seg in enumerate(self.segments[s]):
            g = seg.global_ids
            keep = (self.alive[g] & (self.shard_of[g] == s)
                    & (self.seg_of[g] == k))
            rows = np.flatnonzero(keep)
            pieces.append((seg.layout, rows, g[rows]))
        return pieces

    def _compact_shard(self, s: int) -> dict:
        """Merge shard ``s``'s base + segments minus tombstones into one
        fresh run. Optimistic: the (expensive) block merge runs outside the
        routing lock against immutable blobs; if a mutation raced in, retry
        against the new snapshot, degrading to a fully locked pass."""
        for attempt in range(_COMPACT_RETRIES + 1):
            locked = attempt == _COMPACT_RETRIES
            self._mut_lock.acquire()
            version = self._shard_version[s]
            pieces = self._live_pieces(s)
            old_blocks = self._shard_disk_blocks(s)
            n_segments = len(self.segments[s])
            if not locked:
                self._mut_lock.release()
            try:
                new_layout, new_gids = merge_rows(pieces, like=self.layout)
            except BaseException:
                if locked:
                    self._mut_lock.release()
                raise
            if not locked:
                self._mut_lock.acquire()
            try:
                if self._shard_version[s] != version:
                    continue                       # raced; retry
                live_blocks = int(new_layout.offsets[:, 1].sum())
                self.shards[s].layout = new_layout
                # every physical address moved: the O/S page cache of this
                # shard holds nothing valid (counters keep accumulating)
                self.shards[s].page_cache._lru.clear()
                dead_here = np.flatnonzero(~self.alive
                                           & (self.shard_of == s))
                self.shard_of[dead_here] = -1
                self.seg_of[dead_here] = -1
                self.shard_ids[s] = new_gids
                self.local_of[new_gids] = np.arange(len(new_gids))
                self.seg_of[new_gids] = -1
                self.segments[s] = []
                self._shard_version[s] += 1
                secs = 2.0 * self.shards[s].spec.read_time(live_blocks,
                                                           qd=self.qd)
                with self._lock:
                    self.stats["compactions"] += 1
                    self.stats["compaction_bytes"] += \
                        2 * live_blocks * self.layout.block
                    self.stats["compaction_seconds"] += secs
                return {"shard": s, "segments_merged": n_segments,
                        "blocks_before": old_blocks,
                        "blocks_after": live_blocks,
                        "blocks_reclaimed": old_blocks - live_blocks}
            finally:
                self._mut_lock.release()
        raise RuntimeError("unreachable")          # pragma: no cover

    def compact(self, shard: int | None = None) -> dict:
        """Compact one shard (or all): merge segments + drop dead rows into
        fresh block-aligned runs. Returns an aggregate report."""
        with self._mut_lock:
            self._check_open()
        tr = self.tracer
        t_mut0 = tr.clock() if tr is not None else 0.0
        if tr is not None:
            with self._lock:
                secs0 = self.stats["compaction_seconds"]
        shards = range(self.n_shards) if shard is None else [shard]
        reports = [self._compact_shard(s) for s in shards]
        out = {"shards": reports,
               "segments_merged": sum(r["segments_merged"]
                                      for r in reports),
               "blocks_reclaimed": sum(r["blocks_reclaimed"]
                                       for r in reports)}
        if tr is not None:
            with self._lock:
                secs = self.stats["compaction_seconds"] - secs0
            tr.add("compaction", cat="mutation", t0=t_mut0, t1=tr.clock(),
                   sim_s=secs, segments_merged=out["segments_merged"],
                   blocks_reclaimed=out["blocks_reclaimed"])
        return out

    # -- rebalancing ---------------------------------------------------------
    def rebalance(self, skew_threshold: float | None = None) -> dict:
        """Move docs from the heaviest shard (live block mass) toward the
        lightest until their masses meet. ``skew_threshold``: only act when
        ``max_mass > threshold * min_mass`` (e.g. 1.5); ``None`` always
        balances. Moved rows land as ONE migration segment on the
        destination; the source rows become dead space reclaimed by its
        next compaction. Both sides are billed: ``migration_bytes`` counts
        the moved blocks twice (read at the source, written at the
        destination)."""
        tr = self.tracer
        t_mut0 = tr.clock() if tr is not None else 0.0
        with self._mut_lock:
            self._check_open()
            no_op = {"moved_docs": 0, "moved_blocks": 0, "src": None,
                     "dst": None}
            if self.n_shards < 2:
                return no_op
            mass = self._live_block_mass()
            src, dst = int(np.argmax(mass)), int(np.argmin(mass))
            if src == dst:
                return no_op
            if (skew_threshold is not None
                    and mass[src] <= skew_threshold * max(1, mass[dst])):
                return no_op
            target = (mass[src] - mass[dst]) // 2
            # newest docs first: they are likeliest to sit in segments and
            # cheapest to strand (their source blocks die with the segment)
            cand = np.flatnonzero(self.alive & (self.shard_of == src))[::-1]
            moved, acc = [], 0
            for g in cand:
                b = int(self.layout.offsets[g, 1])
                if acc + b > target:
                    break
                moved.append(int(g))
                acc += b
            if not moved:
                return no_op
            moved = np.asarray(moved, np.int64)
            so = self.seg_of[moved]
            pieces = []
            base = moved[so < 0]
            if len(base):
                pieces.append((self.shards[src].layout,
                               self.local_of[base], base))
            for k in np.unique(so[so >= 0]):
                m = moved[so == k]
                pieces.append((self.segments[src][int(k)].layout,
                               self.local_of[m], m))
            seg_layout, gid_order = merge_rows(pieces, like=self.layout)
            self._attach_segment(dst, Segment(seg_layout, gid_order))
            self._shard_version[src] += 1
            self._shard_version[dst] += 1
            secs = (self.shards[src].spec.read_time(acc, qd=self.qd)
                    + self.shards[dst].spec.read_time(acc, qd=self.qd))
            with self._lock:
                self.stats["rebalances"] += 1
                self.stats["migration_bytes"] += 2 * acc * self.layout.block
                self.stats["migration_seconds"] += secs
            if tr is not None:
                tr.add("rebalance", cat="mutation", t0=t_mut0, t1=tr.clock(),
                       sim_s=secs, docs=len(moved), blocks=acc,
                       src=src, dst=dst)
            return {"moved_docs": len(moved), "moved_blocks": acc,
                    "src": src, "dst": dst}

    # -- observability -------------------------------------------------------
    def metrics_sources(self):
        """Inherited cluster sources (which already expose the mutation
        counters folded into ``self.stats``) plus live structural gauges:
        segment debt, tombstone count, and the live-doc population."""
        out = super().metrics_sources()

        def snap() -> dict:
            with self._mut_lock:
                return {"segments": sum(len(s) for s in self.segments),
                        "tombstoned_docs": int((~self.alive).sum()),
                        "live_docs": int(self.alive.sum())}

        out.append(("mutation", snap))
        return out

    # -- background maintenance ----------------------------------------------
    def _needs_compact(self, s: int) -> bool:
        n_segs = len(self.segments[s])
        phys = self._shard_disk_blocks(s)
        live = int(self._live_block_mass()[s])
        dead = phys - live
        if self.auto_compact_segments > 0 \
                and n_segs >= self.auto_compact_segments:
            return True
        if self.auto_compact_dead_frac > 0 and phys \
                and dead / phys > self.auto_compact_dead_frac:
            return True
        if self.auto_compact_segments == 0 \
                and self.auto_compact_dead_frac == 0:
            # no thresholds configured: any debt at all triggers
            return n_segs > 0 or dead > 0
        return False

    def maintain(self) -> dict:
        """One self-management pass: compact shards past their segment/dead
        thresholds, then rebalance on skew. The background compactor calls
        this every ``compact_interval_s``; callers may invoke it directly."""
        compacted = [self._compact_shard(s) for s in range(self.n_shards)
                     if self._needs_compact(s)]
        rebal = (self.rebalance(self.rebalance_skew)
                 if self.rebalance_skew > 0 and self.n_shards > 1 else None)
        return {"compacted": compacted, "rebalanced": rebal}

    def _compact_loop(self) -> None:
        while not self._compactor_stop.wait(self.compact_interval_s):
            if self._closed:
                return
            try:
                self.maintain()
            except Exception:                      # pragma: no cover
                pass          # a failed pass must not kill the daemon

    def close(self):
        self._compactor_stop.set()
        if self._compactor is not None:
            self._compactor.join(timeout=5.0)
        super().close()
