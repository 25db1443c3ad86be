"""StorageTier: serves document embeddings through a device model + software
stack. The GDS-analogue path ("espn") issues batched block reads at high
queue depth; "mmap"/"swap" model the conventional O/S paths the paper
compares against; "dram" is the all-in-memory upper bound.

Data movement is real: the tier's threads stage the stored token rows of
each run from the disk-image blob into one host buffer per read (pinned
when the tier's device is CUDA), and the caller's thread copies each run to
the device once (``BatchReadResult.ensure_query``); the *clock* is the
model in storage/ssd.py. Every read returns its simulated duration so the
pipeline can account overlap exactly like the paper's prefetch-budget math.

With a ``FaultInjector`` attached, every device read first runs through the
seeded fault machine on the caller's thread (``_faulty_read_clock``), in the
reference's order, so the fault schedule is the reference's draw for draw:
retries, stalls and repairs are billed on the clock; a read that exhausts
its retry budget moves no rows (its queries are marked failed); an
undetected corruption flips the sign of the victim's token rows in the host
staging buffer before they go to the device (negation is exact in every
float dtype, so the scores are the reference's).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.fde import FDETable
from repro_torch.storage import ssd as ssd_lib
from repro_torch.storage.batch_io import (BatchReadPlan, BatchReadResult,
                                          DeviceArena, _exclusive_cumsum,
                                          serial_batch, upload)
from repro_torch.storage.cache import PageCache
from repro_torch.storage.faults import (FaultInjector, ReadFaultError,
                                        fault_span_counts, zero_fault_stats)
from repro_torch.storage.layout import BitTable, EmbeddingLayout, stage_rows

STACKS = ("espn", "mmap", "swap", "dram")


@dataclass
class ReadResult:
    arena: DeviceArena        # the read's token rows, row j = ids[j]
    sim_seconds: float        # modeled device+software time
    n_blocks: int


class StorageTier:
    def __init__(self, layout: EmbeddingLayout, *,
                 spec: ssd_lib.StorageSpec = ssd_lib.PM983_PCIE3,
                 stack: str = "espn", mem_budget_bytes: int | None = None,
                 t_max: int = 180, qd: int = 64, include_h2d: bool = True,
                 n_io_threads: int = 4, bits: BitTable | None = None,
                 fde: FDETable | None = None, coalesce: bool = True,
                 io_chunk_docs: int | None = None,
                 faults: FaultInjector | None = None, tracer=None,
                 device: str | torch.device = "cuda"):
        if stack not in STACKS:
            raise ValueError(f"unknown storage stack {stack!r}; "
                             f"expected one of {STACKS}")
        self.layout = layout
        self.tracer = tracer          # repro_torch.obs.Tracer | None (off)
        self.bits = bits              # resident sign-bit tier (bit filter)
        self.fde = fde                # resident FDE tier (fde candidate gen)
        self._closed = False
        self.spec = spec
        self.stack = stack
        self.t_max = t_max
        self.qd = qd
        self.include_h2d = include_h2d
        self.coalesce = coalesce      # read_batch default: coalesced vs serial
        self.io_chunk_docs = io_chunk_docs   # pipelining granularity (docs/run)
        self.device = torch.device(device)   # where read arenas live
        self._pool = ThreadPoolExecutor(max_workers=n_io_threads,
                                        thread_name_prefix="espn-io")
        self._lock = threading.Lock()
        budget = mem_budget_bytes if mem_budget_bytes is not None else 0
        self.page_cache = PageCache(budget, layout.block)
        if stack == "swap":
            self.swap_capacity = (mem_budget_bytes or 0) + 32 * 2**30
        self.stats = {"reads": 0, "docs": 0, "doc_requests": 0, "blocks": 0,
                      "sim_seconds": 0.0, "batch_reads": 0, "io_runs": 0,
                      "dedup_docs": 0}
        self.faults = faults          # FaultInjector | None (None = inert)
        self.degrade_reads = faults.cfg.degrade if faults is not None \
            else True
        if faults is not None:
            self.stats |= zero_fault_stats()
            self._fault_seq = 0

    # -- timing ------------------------------------------------------------
    def _pages_of(self, ids) -> np.ndarray:
        """Pages (device blocks) touched by ``ids``, vectorized."""
        offs = self.layout.offsets[np.asarray(ids, np.int64).ravel()]
        starts, counts = offs[:, 0], offs[:, 1]
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int64)
        base = np.repeat(starts - _exclusive_cumsum(counts), counts)
        return base + np.arange(total, dtype=np.int64)

    def _sim_time(self, ids) -> tuple[float, int]:
        n_blocks = self.layout.blocks_for(ids)
        bytes_moved = n_blocks * self.layout.block
        if self.stack == "dram":
            t = ssd_lib.DRAM.read_time(n_blocks, qd=self.qd)
        elif self.stack == "espn":
            t = self.spec.read_time(n_blocks, qd=self.qd)
        else:
            pages = self._pages_of(ids)
            with self._lock:
                h, m = self.page_cache.access_many(pages)
            hr = h / max(1, h + m)
            if self.stack == "mmap":
                t = ssd_lib.mmap_read_time(self.spec, len(pages), hr)
            else:
                if self.layout.nbytes > self.swap_capacity:
                    raise MemoryError("OOM: index exceeds memory + swap space")
                t = ssd_lib.swap_read_time(self.spec, len(pages), hr)
        if self.include_h2d and self.stack != "dram":
            t += ssd_lib.h2d_time(bytes_moved)
        return t, n_blocks

    # -- fault injection -----------------------------------------------------
    def _repair_time(self, n_blocks: int) -> float:
        """One extra device read of a corrupted record (repair bill)."""
        if self.stack == "dram":
            return ssd_lib.DRAM.read_time(n_blocks, qd=self.qd)
        return self.spec.read_time(n_blocks, qd=self.qd)

    def _faulty_read_clock(self, base_s: float, ids) -> tuple[float, int,
                                                              bool, dict]:
        """Run one device read through the fault machine (single device: no
        failover target). Returns ``(sim_s, corrupt_pos, ok, events)``: the
        clock including retries/stalls/repair, the position in ``ids`` whose
        rows must be corrupted (-1 = none: no corruption, or it was detected
        and repaired), whether the read succeeded at all, and the read's
        event counts (empty when nothing fired). The counters fold into
        ``self.stats``."""
        fi = self.faults
        with self._lock:
            seq = self._fault_seq
            self._fault_seq += 1
        if not fi.any_event(seq, 0, 0):
            return base_s, -1, True, {}
        ev = zero_fault_stats()
        # a single tier has one "replica"; a flap is an outage for this read
        if fi.flap(seq, 0, 0):
            ev["replica_flaps"] += 1
            ev["faults_injected"] += 1
            elapsed, ok = 0.0, False
        else:
            elapsed, ok = fi.attempt_loop(seq, 0, 0, base_s, ev)
        corrupt_pos = -1
        if ok and len(ids) and fi.corrupt(seq, 0):
            ev["corruptions_injected"] += 1
            ev["faults_injected"] += 1
            v = fi.victim(seq, 0, len(ids))
            gid = int(np.asarray(ids, np.int64)[v])
            if fi.cfg.checksum \
                    and fi.wire_corruption_detected(self.layout, gid):
                # detected: repair = re-read the record (the on-device image
                # is healthy; the corruption was on the wire). Billed to
                # repair_bytes, never to the query's unique-bytes bill.
                ev["checksum_failures"] += 1
                ev["repairs"] += 1
                nbv = self.layout.blocks_for([gid])
                ev["repair_bytes"] += nbv * self.layout.block
                elapsed += self._repair_time(nbv)
            else:
                corrupt_pos = v    # undetected: corrupt rows reach scoring
        with self._lock:
            for k, n in ev.items():
                self.stats[k] += n
        return elapsed, corrupt_pos, ok, ev

    def _faults_on(self) -> bool:
        return self.faults is not None and self.faults.cfg.enabled()

    @staticmethod
    def _corrupt(arena: DeviceArena, rows: np.ndarray, row: int, a: int,
                 b: int) -> None:
        """Undetected wire corruption of arena row ``row``, whose token rows
        are staged at ``rows[a:b]``: its values change sign (the worst case
        for MaxSim, as in the reference). A layout with per-doc scales
        negates the scale instead, which is exact for integer storage
        too."""
        if arena.scales is not None:
            arena.scales[row] = -arena.scales[row]
        else:
            np.negative(rows[a:b], out=rows[a:b])

    # -- reads ---------------------------------------------------------------
    def _arena(self, ids: np.ndarray, lens: np.ndarray, t_max: int):
        """The arena of a read of ``ids`` (``lens`` token rows each) on the
        tier's device, and the host buffer its rows are staged in (pinned on
        CUDA; on the CPU the two are one tensor). Called on the caller's
        thread."""
        dtype = torch.from_numpy(np.empty(0, self.layout.dtype)).dtype
        on_card = self.device.type == "cuda"
        staging = torch.empty((int(lens.sum(dtype=np.int64)),
                               self.layout.d_bow), dtype=dtype,
                              pin_memory=on_card)
        pool = (torch.empty_like(staging, device=self.device) if on_card
                else staging)
        scales = self.layout.scales
        arena = DeviceArena(
            pool=pool, first=torch.as_tensor(
                _exclusive_cumsum(lens.astype(np.int64)), device=self.device),
            lens=torch.as_tensor(lens, device=self.device),
            scales=(torch.as_tensor(np.asarray(scales[ids], np.float32),
                                    device=self.device)
                    if scales is not None else None),
            t_max=t_max)
        return arena, staging

    def read(self, ids, t_max: int | None = None) -> ReadResult:
        """One blocking read of ``ids``: staged on the caller's thread and
        copied to the tier's device."""
        ids = np.asarray(ids, np.int64)
        t_max = t_max or self.t_max
        sim, n_blocks = self._sim_time(ids)
        corrupt_pos = -1
        if self._faults_on():
            sim, corrupt_pos, ok, _ = self._faulty_read_clock(sim, ids)
            if not ok:
                with self._lock:
                    self.stats["sim_seconds"] += sim
                raise ReadFaultError(
                    "storage read failed after exhausting retries")
        lens = np.minimum(self.layout.n_tokens[ids], t_max).astype(np.int32)
        arena, staging = self._arena(ids, lens, t_max)
        rows = staging.numpy()
        stage_rows(self.layout, ids, t_max, rows)
        if corrupt_pos >= 0:
            a = int(lens[:corrupt_pos].sum(dtype=np.int64))
            self._corrupt(arena, rows, corrupt_pos, a,
                          a + int(lens[corrupt_pos]))
        upload(arena, staging, 0, len(staging))
        with self._lock:
            self.stats["reads"] += 1
            self.stats["docs"] += len(ids)
            self.stats["doc_requests"] += len(ids)
            self.stats["blocks"] += n_blocks
            self.stats["sim_seconds"] += sim
        return ReadResult(arena, sim, n_blocks)

    def read_async(self, ids, t_max: int | None = None) -> Future:
        """``read`` on the tier's pool: the future's result is its
        ``ReadResult`` (the copy to the device issued from the pool
        thread)."""
        return self._pool.submit(self.read, ids, t_max)

    def read_batch(self, per_query_ids, t_max: int | None = None, *,
                   coalesce: bool | None = None,
                   skip_empty: bool = False) -> BatchReadResult:
        """One storage transaction for a whole query batch.

        Coalesced (the default, ``self.coalesce``): doc ids are dedup'd
        across queries, runs are staged concurrently on the tier's thread
        pool into one host buffer (call ``ensure_query(b)`` before
        consuming query ``b``'s rows: it also issues the runs' copies to
        the device), and the clock bills ONE read of the unique blocks at
        this tier's queue depth.

        ``coalesce=False``: one blocking ``read`` per query, duplicates
        billed per requesting query (``skip_empty`` skips zero-id queries).
        """
        t_max = t_max or self.t_max
        coalesce = self.coalesce if coalesce is None else coalesce
        tr = self.tracer
        lists = [np.asarray(x, np.int64).ravel() for x in per_query_ids]
        if not coalesce:
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
                                   chunk_docs=self.io_chunk_docs)
        if tr is not None:
            plan.span = tr.add("plan", cat="io", t0=t_plan0, t1=tr.clock(),
                               n_unique=plan.n_unique,
                               n_blocks=plan.n_blocks)
        u = plan.n_unique
        if u == 0:
            arena, staging = self._arena(plan.arena_ids, plan.arena_lens,
                                         t_max)
            return BatchReadResult(coalesced=True, plan=plan,
                                   sim_seconds=0.0, n_blocks=0, arena=arena,
                                   staging=staging)
        t_rb0 = tr.clock() if tr is not None else 0.0
        sim, n_blocks = self._sim_time(plan.arena_ids)
        corrupt_row = -1
        fault_ev: dict = {}

        def _rb_span(sim_s: float, nb: int, failed: bool = False):
            """Retroactive read_batch span + fault-event child spans."""
            sp = tr.add("read_batch", cat="io", t0=t_rb0, t1=tr.clock(),
                        sim_s=sim_s, n_unique=plan.n_unique, n_blocks=nb,
                        failed=failed)
            for name, count in fault_span_counts(fault_ev):
                tr.add(name, cat="fault", t0=sp.t0, t1=sp.t1, parent=sp,
                       count=count)
            return sp

        if self._faults_on():
            sim, corrupt_row, ok, fault_ev = self._faulty_read_clock(
                sim, plan.arena_ids)
            if not ok:
                # the coalesced transaction is one device read: when it
                # exhausts the retry budget every query in the batch is
                # marked failed (a single tier has no failover target), and
                # no row is staged, copied or scored
                with self._lock:
                    self.stats["reads"] += 1
                    self.stats["batch_reads"] += 1
                    self.stats["doc_requests"] += plan.n_requested
                    self.stats["sim_seconds"] += sim
                res = BatchReadResult(
                    coalesced=True, plan=plan, sim_seconds=sim, n_blocks=0,
                    failed_queries=np.ones(len(lists), bool))
                if tr is not None:
                    res.span = _rb_span(sim, 0, failed=True)
                return res
        arena, staging = self._arena(plan.arena_ids, plan.arena_lens, t_max)
        rows = staging.numpy()

        def _stage_corrupted(r0: int, r1: int) -> None:
            stage_rows(self.layout, plan.arena_ids[r0:r1], t_max,
                       rows[slice(*plan.pool_range(r0, r1))])
            a = int(plan.arena_first[corrupt_row])
            self._corrupt(arena, rows, corrupt_row, a,
                          a + int(plan.arena_lens[corrupt_row]))

        if corrupt_row >= 0 and arena.scales is not None:
            # the scale flip touches a device tensor: on this thread
            self._corrupt(arena, rows, corrupt_row, 0, 0)
            corrupt_row = -1
        futures = [self._pool.submit(_stage_corrupted, r0, r1)
                   if r0 <= corrupt_row < r1 else
                   self._pool.submit(
                       stage_rows, self.layout, plan.arena_ids[r0:r1], t_max,
                       rows[slice(*plan.pool_range(r0, r1))])
                   for r0, r1 in plan.runs]
        with self._lock:
            self.stats["reads"] += 1
            self.stats["batch_reads"] += 1
            self.stats["io_runs"] += len(plan.runs)
            self.stats["docs"] += u
            self.stats["doc_requests"] += plan.n_requested
            self.stats["dedup_docs"] += plan.n_requested - u
            self.stats["blocks"] += n_blocks
            self.stats["sim_seconds"] += sim
        res = BatchReadResult(coalesced=True, plan=plan, sim_seconds=sim,
                              n_blocks=n_blocks, arena=arena,
                              staging=staging, futures=futures)
        if tr is not None:
            res.span = _rb_span(sim, n_blocks)
            res.tracer = tr
        return res

    def read_bits(self, ids, t_max: int | None = None):
        """Gather packed sign bits for ``ids`` from the *resident* bit tier:
        no SSD blocks, no simulated device time (the read is a memory
        access)."""
        if self.bits is None:
            raise RuntimeError(
                "this StorageTier was built without a resident BitTable; "
                "construct it with bits=pack_bits(...)")
        return self.bits.gather(ids, t_max or self.t_max)

    # -- reporting -----------------------------------------------------------
    def memory_resident_bytes(self) -> int:
        """Host/device memory this tier requires (ESPN: offsets only, plus
        any resident side tables)."""
        meta = self.layout.meta_nbytes
        if self.bits is not None:
            meta += self.bits.nbytes
        if self.fde is not None:
            meta += self.fde.nbytes
        if self.stack == "dram":
            return self.layout.nbytes + meta
        if self.stack in ("mmap", "swap"):
            return self.page_cache.capacity_pages * self.layout.block + meta
        return meta

    def metrics_sources(self) -> list:
        """``(prefix, snapshot_fn)`` pairs for a ``MetricsRegistry``:
        everything in ``self.stats`` (the fault counters too when an
        injector is attached) plus the resident-bytes gauge. Snapshots run
        at expose() time only."""
        def snap():
            with self._lock:
                s = dict(self.stats)
            s["memory_resident_bytes"] = self.memory_resident_bytes()
            return s
        return [("storage_tier", snap)]

    def close(self):
        """Idempotent shutdown: pending reads are cancelled rather than
        abandoned; in-flight reads finish."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=False, cancel_futures=True)
